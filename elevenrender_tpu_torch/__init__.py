"""ElevenRender on PyTorch and CUDA: the port of ``elevenrender_tpu``.

The package mirrors the JAX package's layout (``core/``, ``scene/``,
``ops/``, ``render/``) so each module's counterpart is easy to find.  It
imports torch and numpy only.  Plain tensor math is eager PyTorch; the
BVH traversal, which the JAX package wrote as a Pallas TPU kernel, is a
hand-written CUDA kernel (``csrc/bvh_traverse.cu``) whose wrapper lives
in ``ops/traverse.py``.

Entry points (``Scene.build``, ``build_ir``, ``ir_from_numpy``,
``Renderer``, ``render_sample``) run on ``device="cuda"`` unless the
caller asks for ``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"

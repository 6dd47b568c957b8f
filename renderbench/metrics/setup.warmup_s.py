"""setup.warmup_s: host seconds from the built scene to the window's
first unit: the driver's warm-up, which builds and loads the kernel
libraries and captures the CUDA graphs (render/dispatch.py,
render/grad.py, kernels.py), from the harness's span around it."""


def read(ctx):
    return ctx["spans"].get("setup.warmup_s")

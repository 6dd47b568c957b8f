"""Traversal kernels outside the render path: measured beside the binary
walk by ``sweep_traverse``, reached by no ``RenderConfig``."""

"""setup.scene_s: host seconds for the port to build its scene IR
on the card from the raw scene the harness made (scene/, ops/bvh.py,
ops/native.py -> csrc/elevenrt.cpp), from the harness's span around the
build.  The harness's own generator, which makes the raw scene with its
tangents, is outside the span."""


def read(ctx):
    return ctx["spans"].get("setup.scene_s")

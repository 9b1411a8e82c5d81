"""scene_build_s: seconds of the program's parse of the scene file and
its scene build on the device (Morton clusters of a mesh included), a
host clock around those calls in set-up."""


def read(run):
    return run.spans.get("scene_build_s")

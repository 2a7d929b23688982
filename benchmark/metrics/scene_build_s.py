"""scene_build_s: host seconds of the program's ``load_pbrt`` in set-up
(parse, PLY, EXR and PNG decodes, mip atlas, alias tables, LBVH and
face tables)."""


def read(record):
    return record["scene_build_s"]

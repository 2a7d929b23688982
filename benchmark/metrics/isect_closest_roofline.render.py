"""isect_closest_roofline.render: the closest-hit query's share of its
roofline at a wave's launches 0 and 8: 100 x the summed walk-work bounds
over the summed times of the program's ``intersect_faces`` (CUDA events,
wrapper included). The bound is the work an LBVH walk needs on those
rays (``harness/roofline.py``), whatever answered the query."""


def read(record):
    if record["kind"] != "render_regen":
        return None
    rows = [q for q in record.get("queries", [])
            if q["kind"] == "closest" and q["ms"]]
    if not rows:
        return None
    return 100.0 * sum(q["bound_ms"] for q in rows) / sum(q["ms"]
                                                          for q in rows)

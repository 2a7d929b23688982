"""isect_any_roofline.render: the any-hit (shadow) query's share of
its roofline at a wave's launches 0 and 8, as the closest hit's."""


def read(record):
    if record["kind"] != "render_regen":
        return None
    rows = [q for q in record.get("queries", [])
            if q["kind"] == "any" and q["ms"]]
    if not rows:
        return None
    return 100.0 * sum(q["bound_ms"] for q in rows) / sum(q["ms"]
                                                          for q in rows)

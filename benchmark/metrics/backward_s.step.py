"""backward_s.step: host clock around one step's ``loss.backward()``,
synchronized at both ends (a traced unit outside the window)."""


def read(record):
    if record["kind"] != "step":
        return None
    return record.get("spans", {}).get("backward")

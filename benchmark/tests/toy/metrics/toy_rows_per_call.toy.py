"""Rows answered a call in the window."""


def read(rec):
    return rec["rows"] if rec.get("calls") else None

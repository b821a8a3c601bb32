"""The card's allocation peak within the window, in GB."""


def read(rec):
    b = rec.get("peak_window_bytes")
    return b / 1e9 if rec["kind"] == "proof" and b else None

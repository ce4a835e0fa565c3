"""Device operations (kernels, copies and fills, as the raw trace counts
them) a frame over the profiled stretch after the window."""


def read(record):
    tr = (record or {}).get("trace")
    if not tr or not tr["frames"]:
        return None
    return tr["launches"] / tr["frames"]

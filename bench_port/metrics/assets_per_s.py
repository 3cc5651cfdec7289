"""Assets completed in the window (non-empty meshes returned) divided by
the window's seconds, from its first batch handed over to its last batch
returned (host clock)."""


def read(stats, cell):
    if not stats.get("window_s"):
        return None
    return stats["completed"] / stats["window_s"]

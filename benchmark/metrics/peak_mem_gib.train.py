"""The caching allocator's peak over the window (max_memory_allocated after
reset_peak_memory_stats at the window's start), GiB."""


def read(record):
    if record.get("kind") != "train" or not record.get("window_peak_bytes"):
        return None
    return record["window_peak_bytes"] / 2**30

"""The engines' copies between host and card (``upload_ms`` +
``trace_pull_ms`` + ``bytes_pull_ms``), per MB delivered."""

KEYS = ("upload_ms", "trace_pull_ms", "bytes_pull_ms")


def read(run):
    if not any(run.has(k) for k in KEYS) or not run.delivered_bytes:
        return None
    return sum(run.total(k) for k in KEYS) / (run.delivered_bytes / 1e6)

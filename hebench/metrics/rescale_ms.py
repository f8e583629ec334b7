"""rescale_ms: device ms a request inside the benchmark's rescale span (CUDA
events around each call, summed over the traced window)."""


def read(r):
    ms = r.span_ms.get("rescale")
    return None if ms is None or not r.requests else ms / r.requests

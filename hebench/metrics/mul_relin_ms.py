"""mul_relin_ms: device ms a request inside the benchmark's mul_relin span (CUDA
events around each call, summed over the traced window)."""


def read(r):
    ms = r.span_ms.get("mul_relin")
    return None if ms is None or not r.requests else ms / r.requests

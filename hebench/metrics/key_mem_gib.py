"""key_mem_gib: device memory the secret key and every evaluation key
hold (torch.cuda.memory_allocated() after key generation less before)."""


def read(r):
    return None if r.key_mem_bytes is None else r.key_mem_bytes / 2**30

"""Small host-side helpers shared across the library.

Behavioral parity with upstream zksnake: python/zksnake/utils.py (OS-entropy
sampling, chunking, next-pow-2, batch inversion); the implementations here are
original. `batch_modinv` is the host fallback — the device path lives in
backend.field (prefix_prod / mont_inv_batch).
"""

import os
import secrets
import time


def get_random_int(n_max: int) -> int:
    """Uniform random integer in [1, n_max] drawn from the OS entropy pool."""
    return 1 + secrets.randbelow(n_max)


def get_n_jobs() -> int:
    """Host-side worker count (env ZKSNAKE_PARALLEL_CPU, default 1)."""
    return int(os.environ.get("ZKSNAKE_PARALLEL_CPU") or 1)


def split_list(data, size: int):
    """Chop `data` into consecutive chunks of `size` (last may be short)."""
    return [data[off : off + size] for off in range(0, len(data), size)]


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 2 ** max(0, (n - 1).bit_length())


def is_power_of_two(n: int) -> bool:
    return n & (n - 1) == 0


def inner_product(a, b, p: int) -> int:
    """<a, b> mod p."""
    acc = 0
    for x, y in zip(a, b):
        acc += x * y
    return acc % p


def batch_modinv(values, m: int):
    """Invert every element of `values` mod m with ONE modular exponentiation.

    Montgomery's trick: fold the list into inclusive running products, invert
    the total, then peel the inverse back element by element. O(n) mults +
    one pow(-1). Raises (via pow) if any element is non-invertible.
    """
    running = []
    acc = 1
    for v in values:
        acc = acc * v % m
        running.append(acc)
    if not values:
        return []
    inv_acc = pow(acc, -1, m)
    out = [0] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = running[i - 1] * inv_acc % m
        inv_acc = inv_acc * values[i] % m
    out[0] = inv_acc
    return out


class Timer:
    """Context manager that prints elapsed wall-clock seconds on exit."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        print(f"{self.name}: {self.elapsed:.2f} seconds")
        return False

"""Everything a run draws, as a function of --seed alone.

Each stream is a random.Random seeded with a string built from the seed and
the stream's name, which Python hashes the same way in every process. The
program and the plain reference draw from the same streams: the protocol's
own draws (the toxic waste, tau, each proof's blinding) through det_random,
and each request's input through request_input.
"""

import random


def stream(seed, name):
    return random.Random(f"portbench:{int(seed)}:{name}")


class patched:
    """Attributes of `module` set to `values` inside the block, restored
    after (frozen copy of chip_smoke.py::patched)."""

    def __init__(self, module, **values):
        self.module, self.values = module, values

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


def det_random(module, rng):
    """`module`.get_random_int drawing 1 + rng.randrange(n) inside the
    block (frozen copy of chip_smoke.py::det_random, taking the generator
    instead of its seed and keeping no list of draws)."""
    return patched(module, get_random_int=lambda n_max: 1 + rng.randrange(n_max))


def protocol_draws(seed, n_max, count):
    """The first `count` values det_random hands the protocol on this seed,
    each draw made with bound n_max."""
    rng = stream(seed, "protocol")
    return [1 + rng.randrange(n_max) for _ in range(count)]


def request_input(seed, k, modulus):
    """Request k's circuit input, uniform in [0, modulus)."""
    return stream(seed, f"request:{k}").randrange(modulus)


def sample(seed, population, k):
    """k members of `population` drawn from the seed, in their order."""
    pop = list(population)
    if k >= len(pop):
        return pop
    picked = set(stream(seed, "sample").sample(range(len(pop)), k))
    return [x for i, x in enumerate(pop) if i in picked]

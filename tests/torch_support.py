"""The shared footing of the port's CPU tests (tests/test_torch_*.py).

Every port test module imports this one before it builds a tensor. On
import it pins torch to one intra-op thread, once, for the whole process.
The port's plain kernels run eager torch ops over 16 or 24 limb lanes, far
too few to split: with torch's default of one thread a core, eight threads
wake and spin for every tiny `sum` or `constant_pad_nd`, and under the
suite's six xdist workers each worker's eight threads fight over the same
eight cores. test_torch_kzg_cells.py's module fixture took 146 s that way
and about 4 s on one thread. `torch.set_num_threads` holds for the whole
process, and `--dist loadfile` runs several modules in one worker, so a pin
in some modules only made a module's time depend on what ran before it in
its worker; here every port module sets it, whichever comes first.

A thread count does not cross a process boundary, so two child processes
pin themselves: the ISOLATED script of test_torch_groth16.py (run with jax
and zksnake_tpu blocked) and `_rank_main` of test_torch_sharding.py (the
spawned gloo ranks).

The spawned ranks import their test module, and with it this one, again,
and test_torch_kernels_cuda.py runs on a card's machine, which need not
have jax. So at module level this module imports only torch and the port;
a helper that needs the JAX package imports it inside the function.

test_torch_support.py checks that every port test module imports this one
and that torch runs on one thread.
"""

import random
from pathlib import Path

import numpy as np
import torch

from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, BN254_SCALAR_FIELD
from zksnake_tpu_torch.curves import get_curve_module

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CURVES = ["BN254", "BLS12_381"]
FIELDS = {"BN254": BN254_SCALAR_FIELD, "BLS12_381": BLS12_381_SCALAR_FIELD}
PORT = get_curve_module("BN254", "cpu")  # the port's BN254 curve module on the CPU
CURVE = PORT._curve


def chain_points(module, group, n, step):
    """n distinct host points 5 G, (5 + step) G, ... of G1 or G2 of `module`."""
    gen = module.g1() if group == 1 else module.g2()
    P, d, out = gen * 5, gen * step, []
    for _ in range(n):
        out.append(P)
        P = P + d
    return out


def stream(monkeypatch, seed, *modules):
    """Each module's get_random_int draws from its own random.Random(seed)."""
    for mod in modules:
        rng = random.Random(seed)
        monkeypatch.setattr(mod, "get_random_int", lambda n, rng=rng: 1 + rng.randrange(n))


def random_limbs(p, n, seed):
    """(nl, n) uint32 limbs of values < p; lanes 0, 1, 2 hold 0, 1, p - 1."""
    from zksnake_tpu.backend.field import FieldSpec

    fs = FieldSpec.get(p)
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(fs.nl, n), dtype=np.int64)
    limbs[-1] = rng.integers(0, int(fs.p_limbs[-1]), size=n)
    limbs[:, :3] = fs.raw_to_host([0, 1, p - 1])
    return limbs.astype(np.uint32)


def same(j, t):
    """A JAX (or numpy) array and a torch tensor hold the same integers."""
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))

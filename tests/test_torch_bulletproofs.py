"""Bulletproofs (the inner-product argument and range proofs) on the
PyTorch port against the JAX package, over BN254 and BLS12-381.

Both packages' range_proof modules draw their blinds from one deterministic
stream each, started from the same seed, so every proof must be equal byte
for byte (exact); the inner-product argument has no randomness. The port
runs on device="cpu"; proofs read back from bytes with no device. The JAX
package's generators, carried across as bytes by backend/state.py, prove
the same in the port.
"""

import pytest
import torch

from zksnake_tpu.subprotocol.bulletproofs import InnerProductArgument as JaxIPA
from zksnake_tpu.subprotocol.bulletproofs import RangeProof as JaxRangeProof
from zksnake_tpu.subprotocol.bulletproofs import range_proof as jax_range_proof
from zksnake_tpu_torch.backend.state import points_from_jax
from zksnake_tpu_torch.subprotocol.bulletproofs import (
    InnerProductArgument,
    InnerProductProof,
    RangeProof,
)
from zksnake_tpu_torch.subprotocol.bulletproofs import range_proof as torch_range_proof
from zksnake_tpu_torch.subprotocol.bulletproofs.range_proof import RangeProofObject

from torch_support import CURVES, stream


def pts(points):
    return [bytes(p.to_bytes()) for p in points]


@pytest.mark.parametrize("curve", CURVES)
def test_inner_product_argument_matches_jax(curve):
    a, b = [1, 3, 3, 7], [1, 2, 3, 4]
    ipa, ref = InnerProductArgument(8, curve, device="cpu"), JaxIPA(8, curve)
    assert pts(ipa.G + ipa.H) == pts(ref.G + ref.H)
    proof, comm, z = ipa.prove(a, b)
    want, want_comm, want_z = ref.prove(a, b)
    raw = proof.to_bytes()
    assert raw == want.to_bytes() and pts([comm]) == pts([want_comm]) and z == want_z
    back = InnerProductProof.from_bytes(raw, curve)
    assert back.to_bytes() == raw
    assert ipa.verify(back, comm, z)
    assert not ipa.verify(back, comm, z + 1)


@pytest.mark.parametrize("curve", CURVES)
def test_range_proof_matches_jax(monkeypatch, curve):
    stream(monkeypatch, f"rp-{curve}", jax_range_proof, torch_range_proof)
    rp, ref = RangeProof(32, curve, device="cpu"), JaxRangeProof(32, curve)
    assert pts(rp.G + rp.H + [rp.B, rp.B_blinding]) == pts(ref.G + ref.H + [ref.B, ref.B_blinding])
    proof = rp.prove(1337)
    raw = proof.to_bytes()
    assert raw == ref.prove(1337).to_bytes()
    back = RangeProofObject.from_bytes(raw, curve)
    assert back.to_bytes() == raw
    assert rp.verify(back)
    # out of range: 500 does not fit 8 bits
    small = RangeProof(8, curve, device="cpu")
    assert not small.verify(small.prove(500))


def test_range_proof_generators_carried_from_jax(monkeypatch):
    """The JAX package's range-proof generators, as bytes through
    points_from_jax, give the port's proof the JAX package's bytes."""
    ref = JaxRangeProof(16, "BN254", seed=b"carried")
    rp = RangeProof(16, "BN254", device="cpu")  # the default seed's generators
    carried = points_from_jax("BN254", pts(ref.G + ref.H + [ref.B, ref.B_blinding]))
    rp.G, rp.H, (rp.B, rp.B_blinding) = carried[:16], carried[16:32], carried[32:]
    stream(monkeypatch, "carried", jax_range_proof, torch_range_proof)
    proof = rp.prove(40000)
    assert proof.to_bytes() == ref.prove(40000).to_bytes()
    assert rp.verify(proof)


def test_malformed_bytes_are_refused():
    raw = InnerProductArgument(4, "BN254", device="cpu").prove([1, 2], [3, 4])[0].to_bytes()
    with pytest.raises(ValueError):
        InnerProductProof.from_bytes(raw[:-1])
    with pytest.raises(ValueError):
        RangeProofObject.from_bytes(raw)


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeProof(8, "BN254")
    with pytest.raises(RuntimeError, match="CUDA"):
        InnerProductArgument(8, "BN254")

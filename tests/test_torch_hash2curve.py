"""Hash-to-field and hash-to-curve on the PyTorch port against the JAX
package: the points' hash_to_field / hash_to_curve, the transcript's
hash_to_scalar / hash_to_curve, and the RFC 9380
BLS12381G1_XMD:SHA-256_SSWU_RO_ vectors of tests/test_curves.py. Host work:
no device is named, and none is needed. Exact: ints and point bytes equal.
"""

import pytest

from zksnake_tpu import transcript as jax_transcript
from zksnake_tpu.curves import ec_bls12_381, ec_bn254
from zksnake_tpu_torch import transcript
from zksnake_tpu_torch.curves import hash2curve
from zksnake_tpu_torch.curves.params import CURVES
from zksnake_tpu_torch.curves.point import get_g1_class

import torch_support  # noqa: F401  (torch on one thread)

JAX_MODULES = {"BN254": ec_bn254, "BLS12_381": ec_bls12_381}
MESSAGES = [b"", b"abc", b"hello", bytes(range(200))]


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_point_hashes_match_jax(curve):
    cls, ref = get_g1_class(curve), JAX_MODULES[curve].PointG1
    for msg in MESSAGES:
        f = cls.hash_to_field(b"dst", msg)
        assert f == ref.hash_to_field(b"dst", msg)
        assert 0 <= f < CURVES[curve].p
        pt = cls.hash_to_curve(b"dst", msg)
        assert bytes(pt.to_bytes()) == bytes(ref.hash_to_curve(b"dst", msg).to_bytes())
        assert pt.is_on_curve() and pt.in_subgroup()
    assert cls.hash_to_curve(b"dst", b"hello") != cls.hash_to_curve(b"dst", b"world")
    assert cls.hash_to_curve(b"dst", b"hello") != cls.hash_to_curve(b"tsd", b"hello")


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_transcript_hashes_match_jax(curve):
    for msg in MESSAGES[:3]:
        assert transcript.hash_to_scalar(msg, b"scalar", curve) == \
            jax_transcript.hash_to_scalar(msg, b"scalar", curve)
    one = transcript.hash_to_curve(b"seed", b"G", curve)
    want_one = jax_transcript.hash_to_curve(b"seed", b"G", curve)
    assert bytes(one.to_bytes()) == bytes(want_one.to_bytes())
    chain = transcript.hash_to_curve(b"seed", b"G", curve, 4)
    want = jax_transcript.hash_to_curve(b"seed", b"G", curve, 4)
    assert [bytes(p.to_bytes()) for p in chain] == [bytes(p.to_bytes()) for p in want]
    assert chain[0] == one  # the chain starts at the single point
    assert transcript.hash_to_curve(b"seed", b"G", "BN128") == transcript.hash_to_curve(
        b"seed", b"G", "BN254")


def test_bls12_381_hash_to_curve_rfc9380_vectors():
    """tests/test_curves.py's RFC 9380 vectors on the port's WB-suite map."""
    cls = get_g1_class("BLS12_381")
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    vectors = {
        b"": (
            0x052926ADD2207B76CA4FA57A8734416C8DC95E24501772C814278700EED6D1E4E8CF62D9C09DB0FAC349612B759E79A1,
            0x08BA738453BFED09CB546DBB0783DBB3A5F1F566ED67BB6BE0E8C67E2E81A4CC68EE29813BB7994998F3EAE0C9C6A265,
        ),
        b"abc": (
            0x03567BC5EF9C690C2AB2ECDF6A96EF1C139CC0B2F284DCA0A9A7943388A49A3AEE664BA5379A7655D3C68900BE2F6903,
            0x0B9C15F3FE6E5CF4211F346271D7B01C8F3B28BE689C8429C85B67AF215533311F0B8DFAAA154FA6B88176C229F2885D,
        ),
    }
    for msg, (x, y) in vectors.items():
        p = cls.hash_to_curve(dst, msg)
        assert (p.x, p.y) == (x, y)
        assert p.in_subgroup()


def test_expand_message_matches_rfc9380():
    """expand_message_xmd(SHA-256), RFC 9380 K.1, len_in_bytes = 0x20."""
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    got = hash2curve._expand_message_xmd(b"abc", dst, 0x20)
    assert got.hex() == "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"

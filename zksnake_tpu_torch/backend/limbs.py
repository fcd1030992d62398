"""Host-side codecs between Python bigints and limb tensors.

Representation: a field element is a row of NL little-endian 16-bit limbs
stored in uint32 (so limb products fit exactly in uint32 and column sums of
the schoolbook/CIOS inner loops stay below 2^32 without 64-bit arithmetic —
int64 is emulated on TPU, 16-bit limbs in int32 lanes are the native-speed
choice; cf. SURVEY.md section 7 limb-decomposition plan).
"""

import numpy as np

W = 16  # limb width in bits
MASK = (1 << W) - 1


def n_limbs(p: int) -> int:
    """Limb count for modulus p (full 16-bit limbs covering p, padded to even)."""
    nl = -(-p.bit_length() // W)
    return nl + (nl & 1)  # even count keeps byte length a multiple of 4


def _codec():
    from ..native import get_codec

    return get_codec()


def ints_to_limbs(values, nl: int) -> np.ndarray:
    """List of non-negative ints -> (n, nl) uint32 array of 16-bit limbs."""
    nbytes = nl * 2
    codec = _codec()
    if codec is not None:
        buf = codec.ints_to_bytes(
            values if isinstance(values, list) else list(values), nbytes
        )
    else:
        buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").astype(np.uint32)
    return arr.reshape(len(values), nl)


def limbs_to_ints(arr) -> list:
    """(n, nl) uint32 array (limbs < 2^16) -> list of ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    n, nl = arr.shape
    buf = arr.astype("<u2").tobytes()
    nbytes = nl * 2
    codec = _codec()
    if codec is not None:
        return codec.bytes_to_ints(buf, nbytes)
    return [
        int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") for i in range(n)
    ]


def int_to_limbs(v: int, nl: int) -> np.ndarray:
    return ints_to_limbs([v], nl)[0]


def limbs_to_int(row) -> int:
    return limbs_to_ints(np.asarray(row, dtype=np.uint32).reshape(1, -1))[0]

"""The benchmark circuit, the multiplication chain out = inp^n (upstream
zksnake's benchmarks/benchmark_groth16.py and benchmark_plonk.py), laid
out as the port's front end lays it out, rebuilt here from its definition.

n constraints: v0 = inp * inp, v_i = v_(i-1) * inp for 0 < i < n - 1, and
out = v_(n-2); out is public.
"""

from .bn254 import R


def chain_values(x, n):
    """inp^2 .. inp^n: v_0 .. v_(n-2)."""
    out = [0] * (n - 1)
    acc = x * x % R
    for i in range(n - 1):
        out[i] = acc
        acc = acc * x % R
    return out


# --- R1CS (Groth16) --------------------------------------------------------
#
# Witness columns: 0 the constant 1, 1 out, 2 inp, 3 + i v_i. Row i holds
# (A, B, C) as lists of (column, value): a Mul constraint is A * B = C; the
# last, out = v_(n-2), is v_(n-2) * 1 = out.

R1CS_PUBLIC = 2


def r1cs_rows(n):
    rows = [([(2, 1)], [(2, 1)], [(3, 1)])]
    rows += [([(2 + i, 1)], [(2, 1)], [(3 + i, 1)]) for i in range(1, n - 1)]
    rows.append(([(n + 1, 1)], [(0, 1)], [(1, 1)]))
    return rows


def r1cs_witness(x, n):
    """(public, private): [1, out] and [inp, v_0 .. v_(n-2)]."""
    v = chain_values(x, n)
    return [1, v[-1]], [x % R] + v


# --- Plonkish (PlonK) ------------------------------------------------------
#
# Gate i has selectors (qL, qR, qO, qM, qC) and wires (a, b, c) named by
# variable ("" for none). The multiplications are qM = 1, qO = -1; the last
# gate, out = v_(n-2), is qL = 1 with out public, so its output wire is
# left to the public input (-out at gate n - 1) and its qO is 0.

def plonk_gates(n):
    gates = [((0, 0, R - 1, 1, 0), ("inp", "inp", "v0"))]
    gates += [((0, 0, R - 1, 1, 0), (f"v{i - 1}", "inp", f"v{i}")) for i in range(1, n - 1)]
    gates.append(((1, 0, 0, 0, 0), (f"v{n - 2}", "", "out")))
    return gates


def plonk_permutation(wires):
    """The copy permutation over the 3n slots in column order (all a wires,
    then b, then c): the identity with, for each slot in order, a swap with
    the next slot of the same variable."""
    size = len(wires)
    slots = [wires[i][lane] for lane in range(3) for i in range(size)]
    following, last = {}, {}
    for i, name in enumerate(slots):
        if name:
            if name in last:
                following[last[name]] = i
            last[name] = i
    perm = list(range(3 * size))
    for i in range(3 * size):
        j = following.get(i)
        if j is not None:
            perm[i], perm[j] = perm[j], perm[i]
    return perm


def plonk_witness(x, n):
    """(public, wires): {n - 1: -out} and the flat [a, b, c] per gate, the
    public output wire left 0."""
    v = chain_values(x, n)
    x %= R
    flat = [x, x, v[0]]
    for i in range(1, n - 1):
        flat += [v[i - 1], x, v[i]]
    flat += [v[-1], 0, 0]
    return {n - 1: (-v[-1]) % R}, flat

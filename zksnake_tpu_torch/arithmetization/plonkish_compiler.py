"""Equation list -> Plonkish selectors + copy-constraint permutation.

Port of upstream zksnake: src/arithmetization/plonkish.rs: per-gate selectors
(qL,qR,qO,qM,qC) with wire triple [w_a,w_b,w_c] (consume_constraint, :54-253;
at most two variables per gate), and the copy-constraint permutation over the
3n flattened wire slots (copy_constraint, :255-283 — wires paired with their
next occurrence, applied as sequential swaps of the identity permutation).

The reference's quirks are preserved verbatim (e.g. constants under Sub are
accumulated without negation, plonkish.rs:23-26) since the compiled circuits
must match gate-for-gate. Copy of
zksnake_tpu/arithmetization/plonkish_compiler.py.
"""

from .symbolic import _INPUT, _ADD, _SUB, _MUL, _DIV, _NEG, _CONST
from ..utils import next_power_of_two


class _Acc:
    __slots__ = ("q_var", "q_constant", "var_mul", "touched")

    def __init__(self, q_var, q_constant):
        self.q_var = q_var
        self.q_constant = q_constant
        self.var_mul = 0
        self.touched = []


def _transform(eq, acc, modulus):
    op = eq.op
    if op == _INPUT:
        acc.var_mul += 1
        acc.touched.append(eq.name)
    elif op in (_ADD, _SUB):
        _transform(eq.a, acc, modulus)
        _transform(eq.b, acc, modulus)
    elif op == _MUL:
        if eq.b.op == _CONST:
            _transform(eq.a, acc, modulus)
            acc.q_var *= eq.b.value
        elif eq.a.op == _CONST:
            acc.q_var *= eq.a.value
            _transform(eq.b, acc, modulus)
        else:
            _transform(eq.a, acc, modulus)
            _transform(eq.b, acc, modulus)
    elif op == _NEG:
        _transform(eq.a, acc, modulus)
        acc.q_var = modulus - acc.q_var
    elif op == _CONST:
        acc.q_constant += eq.value
    else:
        raise ValueError(f"Invalid plonkish constraint: {eq.to_expression()}")


def _consume_constraint(constraint, public_input, modulus):
    ql = qr = qo = qm = qc = 0
    w = ["", "", ""]

    lhs = constraint.lhs
    rhs = constraint.rhs

    if lhs.op == _CONST:
        qc = modulus - (lhs.value % modulus)
    elif lhs.op == _INPUT:
        if lhs.name not in public_input:
            qo = modulus - 1
        w[2] = lhs.name
    else:
        raise ValueError(f"Constraint {constraint!r} not in the form of C=A*B")

    op = rhs.op
    if op == _CONST:
        qc += rhs.value
    elif op == _INPUT:
        ql = 1
        w[0] = rhs.name
        qr = 0
    elif op in (_ADD, _SUB):
        accl = _Acc(1, qc)
        _transform(rhs.a, accl, modulus)
        accr = _Acc(1, accl.q_constant)
        accr.var_mul = accl.var_mul
        accr.touched = accl.touched
        _transform(rhs.b, accr, modulus)
        ql = accl.q_var
        qr = accr.q_var
        qc = accr.q_constant
        var_mul = accr.var_mul
        touched = accr.touched
        if var_mul == 0:
            ql = 0
            qr = 0
        elif var_mul <= 1:
            ql %= modulus
            w[0] = touched[0]
            qr = 0
        elif var_mul == 2:
            ql %= modulus
            if op == _SUB:
                if touched[1] in public_input:
                    qr = 0
                else:
                    qr = modulus - (qr % modulus)
            else:
                qr %= modulus
            w[0] = touched[0]
            w[1] = touched[1]
        else:
            raise ValueError(f"More than two variables in single gate: {constraint!r}")
    elif op == _MUL:
        acc = _Acc(1, 0)
        _transform(rhs, acc, modulus)
        if acc.var_mul == 0:
            qc = acc.q_constant
        elif acc.var_mul == 1:
            ql = acc.q_var % modulus
            w[0] = acc.touched[0]
        elif acc.var_mul == 2:
            w[0] = acc.touched[0]
            w[1] = acc.touched[1]
            qm = acc.q_var % modulus
        else:
            raise ValueError(f"More than two variables in single gate: {constraint!r}")
    elif op == _DIV:
        raise ValueError("Division operation is not supported")
    elif op == _NEG:
        acc = _Acc(1, qc)
        _transform(rhs.a, acc, modulus)
        qc = acc.q_constant
        qr = 0
        if acc.var_mul == 0:
            ql = 0
        else:
            if acc.touched[0] not in public_input:
                ql = modulus - (acc.q_var % modulus)
            else:
                ql = 0
            w[0] = acc.touched[0]

    if not w[0] and w[1]:
        w[0], w[1] = w[1], w[0]

    return (ql % modulus, qr % modulus, qo % modulus, qm % modulus, qc % modulus, w)


def _copy_constraint(num_constraint, witness):
    size = len(witness)
    padded_size = next_power_of_two(max(num_constraint, 1)) * 3

    padded_witness = list(witness) + [""] * (padded_size - size)

    # column-major flattening: all a-wires, then b-wires, then c-wires
    w = []
    for i in range(3):
        w.extend(padded_witness[i::3])

    permutation = list(range(padded_size))

    # next-occurrence pairing (reference does a linear scan; same pairs)
    positions = {}
    for i, name in enumerate(w[:size]):
        if name:
            positions.setdefault(name, []).append(i)

    swaps = []
    for i in range(size):
        if not w[i]:
            continue
        plist = positions[w[i]]
        k = plist.index(i)
        if k + 1 < len(plist):
            swaps.append((i, plist[k + 1]))

    for i, j in swaps:
        permutation[i], permutation[j] = permutation[j], permutation[i]

    return permutation


def compile_plonkish(cs):
    result = [
        _consume_constraint(c, cs.public_vars, cs.modulus) for c in cs._constraints
    ]
    witness = []
    for row in result:
        witness.extend(row[5])

    permutation = _copy_constraint(cs.num_constraints(), witness)
    return (result, permutation)

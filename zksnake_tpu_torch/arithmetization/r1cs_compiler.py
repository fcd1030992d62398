"""Equation list -> sparse R1CS triplets.

Port of upstream zksnake: src/arithmetization/r1cs.rs: the linear-combination
walker `transform` (:8-77), the constraint case split (`consume_constraint`,
:79-131: Mul -> A*B=C, Div -> C*B=A, else A*1=C) and the canonical witness
ordering [1, outputs, public inputs, private inputs, intermediates]
(:133-167).
"""

from .symbolic import _INPUT, _ADD, _SUB, _MUL, _DIV, _NEG, _CONST


def _transform(row, eq, witness_index, v, modulus, is_neg):
    op = eq.op
    if op == _CONST:
        c = eq.value % modulus
        if is_neg:
            v.append((row, 0, (modulus - c) % modulus))
        else:
            v.append((row, 0, c))
    elif op == _INPUT:
        index = witness_index[eq.name]
        if is_neg:
            v.append((row, index, modulus - 1))
        else:
            v.append((row, index, 1))
    elif op == _ADD:
        _transform(row, eq.a, witness_index, v, modulus, is_neg)
        _transform(row, eq.b, witness_index, v, modulus, is_neg)
    elif op == _SUB:
        _transform(row, eq.a, witness_index, v, modulus, is_neg)
        _transform(row, eq.b, witness_index, v, modulus, True)
    elif op == _MUL:
        a, b = eq.a, eq.b
        if a.op == _INPUT and b.op == _CONST:
            index = witness_index[a.name]
            value = b.value % modulus
        elif a.op == _CONST and b.op == _INPUT:
            index = witness_index[b.name]
            value = a.value % modulus
        else:
            raise ValueError(f"Invalid R1CS: {eq.to_expression()}")
        if is_neg:
            v.append((row, index, (modulus - value) % modulus))
        else:
            v.append((row, index, value))
    elif op == _DIV:
        raise ValueError(f"Invalid R1CS: {eq.to_expression()}")
    elif op == _NEG:
        _transform(row, eq.a, witness_index, v, modulus, True)


def _consume_constraint(row, constraint, witness_index, modulus):
    a, b, c = [], [], []
    lhs = constraint.lhs
    rhs = constraint.rhs

    op = rhs.op
    if op in (_CONST, _INPUT, _ADD):
        _transform(row, rhs, witness_index, a, modulus, False)
        b.append((row, 0, 1))
        _transform(row, lhs, witness_index, c, modulus, False)
    elif op == _SUB:
        _transform(row, rhs, witness_index, a, modulus, True)
        b.append((row, 0, 1))
        _transform(row, lhs, witness_index, c, modulus, False)
    elif op == _MUL:
        _transform(row, rhs.a, witness_index, a, modulus, False)
        _transform(row, rhs.b, witness_index, b, modulus, False)
        _transform(row, lhs, witness_index, c, modulus, False)
    elif op == _DIV:
        _transform(row, rhs.a, witness_index, c, modulus, False)
        _transform(row, rhs.b, witness_index, b, modulus, False)
        _transform(row, lhs, witness_index, a, modulus, False)
    elif op == _NEG:
        _transform(row, rhs, witness_index, a, modulus, True)
        b.append((row, 0, 1))
        _transform(row, lhs, witness_index, c, modulus, False)

    return (a, b, c)


def get_witness_vector(vars_map, inputs, outputs, public_vars):
    public_input = []
    private_input = []
    intermediate_vars = []

    inputs_set = set(inputs)
    public_set = set(public_vars)
    outputs_set = set(outputs)

    for v in vars_map.keys():
        if v in public_set and v in inputs_set:
            public_input.append(v)
        elif v in inputs_set and v not in public_set:
            private_input.append(v)
        elif v not in outputs_set:
            intermediate_vars.append(v)

    return ["0"] + list(outputs) + public_input + private_input + intermediate_vars


def compile_r1cs(cs):
    witness_map = get_witness_vector(cs.vars, cs.inputs, cs.outputs, cs.public_vars)
    witness_index = {name: i for i, name in enumerate(witness_map)}

    return [
        _consume_constraint(row, constraint, witness_index, cs.modulus)
        for row, constraint in enumerate(cs._constraints)
    ]

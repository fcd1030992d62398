"""Symbolic circuit front-end: expression DAG, equations, constraint system
with witness solver.

Pure-Python port of the reference's Rust core semantics
(upstream zksnake: src/arithmetization/symbolic.rs): Gate variants
Input/Add/Sub/Mul/Div/Neg/Const (symbolic.rs:17-26), equation rearrangement
via isolate_term (:133-182), the assignment-order derivation in
add_constraint (:597-632), Python-callback hints (:634-650), and the
worklist fixpoint solver (:652-795). Kept on host per the north-star design
(the front-end stays Python; the proving backend is the TPU part).

One deliberate divergence: the reference *constructs* a timeout error when
the solver exceeds max_loop but never returns it (symbolic.rs:786-791), so an
underdetermined system loops forever; we raise RuntimeError instead
(SURVEY.md section 5 says not to replicate that latent bug).
"""

from collections import deque

_INPUT = 0
_ADD = 1
_SUB = 2
_MUL = 3
_DIV = 4
_NEG = 5
_CONST = 6

_OP_NAMES = {_ADD: "+", _SUB: "-", _MUL: "*", _DIV: "/"}


class Node:
    __slots__ = ("op", "a", "b", "name", "value")

    def __init__(self, op, a=None, b=None, name=None, value=None):
        self.op = op
        self.a = a
        self.b = b
        self.name = name
        self.value = value

    # --- evaluation (iterative post-order; deep chains exceed Python's
    # recursion limit for big Circom imports) ---
    def evaluate(self, inputs, modulus, memo=None):
        memo = memo if memo is not None else {}
        stack = [(self, False)]
        while stack:
            node, processed = stack.pop()
            nid = id(node)
            if nid in memo:
                continue
            if node.op == _INPUT:
                try:
                    memo[nid] = inputs[node.name] % modulus
                except KeyError:
                    raise KeyError(
                        f"Missing one or more variable on evaluation: {node.name}"
                    )
                continue
            if node.op == _CONST:
                memo[nid] = node.value % modulus
                continue
            if not processed:
                stack.append((node, True))
                if node.a is not None:
                    stack.append((node.a, False))
                if node.b is not None:
                    stack.append((node.b, False))
                continue
            if node.op == _ADD:
                memo[nid] = (memo[id(node.a)] + memo[id(node.b)]) % modulus
            elif node.op == _SUB:
                memo[nid] = (memo[id(node.a)] - memo[id(node.b)]) % modulus
            elif node.op == _MUL:
                memo[nid] = (memo[id(node.a)] * memo[id(node.b)]) % modulus
            elif node.op == _DIV:
                denom = memo[id(node.b)]
                try:
                    dinv = pow(denom, -1, modulus)
                except ValueError:
                    raise ZeroDivisionError("Modular inverse not found")
                memo[nid] = memo[id(node.a)] * dinv % modulus
            elif node.op == _NEG:
                memo[nid] = -memo[id(node.a)] % modulus
        return memo[id(self)]

    def to_expression(self):
        op = self.op
        if op == _INPUT:
            return self.name
        if op == _CONST:
            return str(self.value)
        if op == _ADD:
            return f"({self.a.to_expression()} + {self.b.to_expression()})"
        if op == _SUB:
            return f"({self.a.to_expression()} - {self.b.to_expression()})"
        if op == _MUL:
            return f"{self.a.to_expression()} * {self.b.to_expression()}"
        if op == _DIV:
            return f"{self.a.to_expression()} / {self.b.to_expression()}"
        if op == _NEG:
            return f"-({self.a.to_expression()})"
        raise ValueError(op)

    def contains_target(self, target):
        stack = [self]
        while stack:
            node = stack.pop()
            op = node.op
            if op == _INPUT:
                if node.name == target:
                    return True
            elif op in (_ADD, _SUB, _MUL, _DIV):
                stack.append(node.a)
                stack.append(node.b)
            elif op == _NEG:
                stack.append(node.a)
        return False

    def extract_vars(self, out):
        """Preorder (left-first) variable name extraction, with duplicates —
        matches symbolic.rs:199-212."""
        stack = [self]
        order = []
        # iterative preorder: visit node, then a, then b
        while stack:
            node = stack.pop()
            op = node.op
            if op == _INPUT:
                order.append(node.name)
            elif op in (_ADD, _SUB, _MUL, _DIV):
                stack.append(node.b)
                stack.append(node.a)
            elif op == _NEG:
                stack.append(node.a)
        out.extend(order)

    def isolate_term(self, target, right):
        """Rearrange `self == right` to isolate `target`; symbolic.rs:133-182."""
        op = self.op
        if op == _ADD:
            if self.a.contains_target(target):
                new_rhs = Node(_SUB, right, self.b)
                return self.a.isolate_term(target, new_rhs)
            elif self.b.contains_target(target):
                new_rhs = Node(_SUB, right, self.a)
                return self.b.isolate_term(target, new_rhs)
            raise ValueError("Target term not found in Add gate")
        if op == _SUB:
            if self.a.contains_target(target):
                new_rhs = Node(_ADD, right, self.b)
                return self.a.isolate_term(target, new_rhs)
            elif self.b.contains_target(target):
                new_rhs = Node(_SUB, right, self.a)
                return self.b.isolate_term(target, new_rhs)
            raise ValueError("Target term not found in Sub gate")
        if op == _MUL:
            if self.a.contains_target(target):
                new_rhs = Node(_DIV, right, self.b)
                return self.a.isolate_term(target, new_rhs)
            elif self.b.contains_target(target):
                new_rhs = Node(_DIV, right, self.a)
                return self.b.isolate_term(target, new_rhs)
            raise ValueError("Target term not found in Mul gate")
        if op == _INPUT and self.name == target:
            return right
        raise ValueError(
            f"Unable to rearrange non-linear equation: "
            f"{self.to_expression()} = {right.to_expression()}"
        )


def _to_node(value):
    if isinstance(value, Field):
        return value.inner
    if isinstance(value, int):
        if value < 0:
            raise TypeError("Unsupported operand: negative constant")
        return Node(_CONST, value=value)
    return None


class Field:
    """Symbolic variable / expression handle (pyclass Field, symbolic.rs:256-433).
    Aliased as `Var` in the arithmetization package."""

    __slots__ = ("inner",)

    def __init__(self, var):
        if isinstance(var, Node):
            self.inner = var
        else:
            self.inner = Node(_INPUT, name=str(var))

    @classmethod
    def _from_node(cls, node):
        obj = cls.__new__(cls)
        obj.inner = node
        return obj

    def evaluate(self, inputs, modulus):
        return self.inner.evaluate(inputs, modulus)

    def __add__(self, rhs):
        n = _to_node(rhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_ADD, self.inner, n))

    def __radd__(self, lhs):
        n = _to_node(lhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_ADD, self.inner, n))

    def __sub__(self, rhs):
        n = _to_node(rhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_SUB, self.inner, n))

    def __rsub__(self, lhs):
        n = _to_node(lhs)
        if n is None:
            return NotImplemented
        # NB: matches the reference's __rsub__, which (quirkily) computes
        # self - other rather than other - self (symbolic.rs:322-336)
        return Field._from_node(Node(_SUB, self.inner, n))

    def __neg__(self):
        return Field._from_node(Node(_NEG, self.inner))

    def __mul__(self, rhs):
        n = _to_node(rhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_MUL, self.inner, n))

    def __rmul__(self, lhs):
        n = _to_node(lhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_MUL, self.inner, n))

    def __truediv__(self, rhs):
        n = _to_node(rhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_DIV, self.inner, n))

    def __rtruediv__(self, lhs):
        n = _to_node(lhs)
        if n is None:
            return NotImplemented
        return Field._from_node(Node(_DIV, self.inner, n))

    def __repr__(self):
        return self.inner.to_expression()

    def __str__(self):
        return self.__repr__()

    def __eq__(self, rhs):
        n = _to_node(rhs)
        if n is None:
            return NotImplemented
        return Equation(self.inner, n)

    def __hash__(self):
        return id(self.inner)


class Equation:
    __slots__ = ("lhs", "rhs", "_vars_cache")

    def __init__(self, left, right):
        self.lhs = left.inner if isinstance(left, Field) else left
        self.rhs = right.inner if isinstance(right, Field) else right
        self._vars_cache = None

    def evaluate(self, inputs, modulus):
        left = self.lhs.evaluate(inputs, modulus)
        right = self.rhs.evaluate(inputs, modulus)
        return (left, right)

    def __repr__(self):
        return f"{self.lhs.to_expression()} = {self.rhs.to_expression()}"

    def swap(self):
        self.lhs, self.rhs = self.rhs, self.lhs
        self._vars_cache = None

    def _var_lists(self):
        if self._vars_cache is None:
            lhs_vars = []
            rhs_vars = []
            self.lhs.extract_vars(lhs_vars)
            self.rhs.extract_vars(rhs_vars)
            self._vars_cache = (lhs_vars, rhs_vars)
        return self._vars_cache


class _Constraint:
    __slots__ = ("eq",)

    def __init__(self, eq):
        self.eq = eq


class _Assignment:
    __slots__ = ("name", "node", "_vars")

    def __init__(self, name, node):
        self.name = name
        self.node = node
        self._vars = None

    def var_list(self):
        if self._vars is None:
            out = []
            self.node.extract_vars(out)
            self._vars = out
        return self._vars


class _Hint:
    __slots__ = ("name", "func", "args")

    def __init__(self, name, func, args):
        self.name = name
        self.func = func
        self.args = args


class ConstraintSystem:
    """Constraint system with automatic witness-solving order
    (pyclass ConstraintSystem, symbolic.rs:455-832)."""

    def __init__(self, inputs, outputs, modulus):
        self._constraints = []
        self.vars = {}
        self.modulus = modulus
        self._public_vars = []
        self.sequence = []
        self.assigned = set(inputs)
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    # --- getters matching the pyclass surface ---
    @property
    def constraints(self):
        return list(self._constraints)

    @property
    def public_vars(self):
        return list(self._public_vars)

    def num_constraints(self):
        return len(self._constraints)

    def num_witness(self):
        return len(self.vars)

    # --- construction ---
    def _add_var(self, node):
        stack = [node]
        while stack:
            n = stack.pop()
            op = n.op
            if op == _INPUT:
                if n.name not in self.vars:
                    self.vars[n.name] = 0
            elif op in (_ADD, _SUB, _MUL, _DIV):
                stack.append(n.b)
                stack.append(n.a)
            elif op == _NEG:
                stack.append(n.a)

    def _find_unassigned_var(self, node):
        """First Input var in preorder (left-first), symbolic.rs:502-519."""
        op = node.op
        if op == _INPUT:
            return node.name
        if op in (_ADD, _SUB, _MUL, _DIV):
            return self._find_unassigned_var(node.a) or self._find_unassigned_var(
                node.b
            )
        if op == _NEG:
            return self._find_unassigned_var(node.a)
        return None

    def add_variable(self, var):
        self._add_var(var.inner)

    def set_public(self, var):
        if isinstance(var, str):
            self._public_vars.append(var)
        elif isinstance(var, Field):
            if var.inner.op != _INPUT:
                raise TypeError("Invalid expression")
            self._public_vars.append(var.inner.name)
        elif isinstance(var, list):
            for node in var:
                if not isinstance(node, Field) or node.inner.op != _INPUT:
                    raise TypeError("Invalid expression")
                self._public_vars.append(node.inner.name)
        else:
            raise TypeError("Invalid expression")

    def add_constraint(self, constraint: Equation):
        if constraint.rhs.op in (_INPUT, _CONST) and constraint.lhs.op != _INPUT:
            constraint.swap()

        if constraint.lhs.op == _INPUT:
            name = constraint.lhs.name
            if name not in self.assigned:
                self.assigned.add(name)
                self.sequence.append(_Assignment(name, constraint.rhs))
        else:
            unassigned = self._find_unassigned_var(constraint.lhs)
            if unassigned is not None and unassigned not in self.assigned:
                self.assigned.add(unassigned)
                new_eq = constraint.lhs.isolate_term(unassigned, constraint.rhs)
                self.sequence.append(_Assignment(unassigned, new_eq))

        self._add_var(constraint.lhs)
        self._add_var(constraint.rhs)

        self._constraints.append(constraint)
        self.sequence.append(_Constraint(constraint))

    def unsafe_assign(self, target, func, args):
        """Off-circuit hint: compute `target` with a Python callback once all
        `args` are solved (symbolic.rs:634-650)."""
        if isinstance(target, Field) and target.inner.op == _INPUT:
            self.sequence.append(_Hint(target.inner.name, func, list(args)))
            return
        raise TypeError("Invalid assignment expression")

    # --- solving ---
    def evaluate(self, inputs):
        modulus = self.modulus
        evaluated = set()
        for key in self.inputs:
            if key not in inputs:
                raise KeyError(
                    f"All inputs and outputs variable must present: {key} is missing"
                )
            if key in self.vars:
                self.vars[key] = int(inputs[key])
            evaluated.add(key)

        queue = deque(self.sequence)
        max_loop = len(self.sequence) * 256
        current_loop = 0

        while queue:
            seq = queue.popleft()

            if isinstance(seq, _Constraint):
                lhs_vars, rhs_vars = seq.eq._var_lists()
                unknown = [
                    v for v in lhs_vars + rhs_vars if v not in evaluated
                ]
                if len(unknown) == 0:
                    memo = {}
                    lhs = seq.eq.lhs.evaluate(self.vars, modulus, memo)
                    rhs = seq.eq.rhs.evaluate(self.vars, modulus, memo)
                    assert lhs == rhs, (
                        f"{seq.eq.lhs.to_expression()} != "
                        f"{seq.eq.rhs.to_expression()}"
                    )
                elif len(unknown) == 1:
                    if unknown[0] in lhs_vars:
                        new_eq = seq.eq.lhs.isolate_term(unknown[0], seq.eq.rhs)
                    else:
                        new_eq = seq.eq.rhs.isolate_term(unknown[0], seq.eq.lhs)
                    try:
                        value = new_eq.evaluate(self.vars, modulus)
                    except (ZeroDivisionError, KeyError):
                        pass
                    else:
                        self.vars[unknown[0]] = value
                        evaluated.add(unknown[0])
                    queue.append(seq)
                else:
                    queue.append(seq)

            elif isinstance(seq, _Assignment):
                if all(v in evaluated for v in seq.var_list()):
                    result = seq.node.evaluate(self.vars, modulus)
                    self.vars[seq.name] = result
                    evaluated.add(seq.name)
                else:
                    queue.append(seq)

            elif isinstance(seq, _Hint):
                if all(v in evaluated for v in seq.args):
                    scope = {}
                    for arg in seq.args:
                        if arg not in self.vars:
                            raise KeyError(f"Argument not exist: {arg}")
                        scope[arg] = self.vars[arg]
                    result = seq.func(**scope)
                    if not isinstance(result, int):
                        raise TypeError("Non deterministic result must be Integer")
                    if seq.name in self.vars:
                        self.vars[seq.name] = result
                    evaluated.add(seq.name)
                else:
                    queue.append(seq)

            current_loop += 1
            if current_loop > max_loop:
                # divergence from the reference (latent bug there): raise
                # instead of looping forever
                raise RuntimeError(
                    "Evaluation timeout: unique solution might not exist "
                    "for the given constraints"
                )

    def solve(self, inputs):
        self.evaluate({k: int(v) for k, v in inputs.items()})
        return dict(self.vars)

    def get_witness_vector(self):
        from .r1cs_compiler import get_witness_vector

        return get_witness_vector(
            self.vars, self.inputs, self.outputs, self._public_vars
        )

    def compile_to_r1cs(self):
        from .r1cs_compiler import compile_r1cs

        return compile_r1cs(self)

    def compile_to_plonkish(self):
        from .plonkish_compiler import compile_plonkish

        return compile_plonkish(self)

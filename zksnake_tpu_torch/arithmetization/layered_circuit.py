"""Layered arithmetic circuit (the GKR protocol's input format).

Behavioral parity with
upstream zksnake: python/zksnake/arithmetization/layered_circuit.py: ADD/MUL
gates only, every gate input must come from the previous layer (or the
circuit inputs at layer 0), wire labels dedupe in first-use order. Original
implementation. Copy of zksnake_tpu/arithmetization/layered_circuit.py.
"""

from typing import List, Sequence

_GATE_OPS = {
    "ADD": lambda x, y, p: (x + y) % p,
    "MUL": lambda x, y, p: x * y % p,
}


class LayeredCircuit:
    """Fan-in-2 layered circuit; layer i feeds only layer i+1."""

    def __init__(self, inputs: List[str]):
        self.inputs = inputs
        self.layers = [[]]
        self._used_vars = []
        self._feedable = set(inputs)

    def add_layer(self):
        """Seal the current layer; its outputs become the next layer's
        allowed inputs. A no-op while the current layer is empty."""
        current = self.layers[-1]
        if not current:
            return
        next_feedable = set()
        for _, lhs, rhs, out in current:
            next_feedable.add(out)
            self._used_vars += [lhs, rhs, out]
        self._feedable = next_feedable
        self.layers.append([])

    def add_gate(self, gate_type, input1, input2, output):
        if gate_type not in _GATE_OPS:
            raise ValueError("Invalid gate type")
        if input1 not in self._feedable or input2 not in self._feedable:
            raise ValueError(
                f"Gate inputs {input1}, {input2} must be from outputs "
                + "from previous layers or inputs from first layer"
            )
        if output in self._used_vars:
            raise ValueError(f"Variable already used in another layer: {output}")
        self.layers[-1].append((gate_type, input1, input2, output))

    def add(self, input1, input2, output):
        self.add_gate("ADD", input1, input2, output)

    def mul(self, input1, input2, output):
        self.add_gate("MUL", input1, input2, output)

    def get_wire_label(self):
        """Per layer: the wire names feeding it (first-use order, deduped);
        plus a final entry with the last layer's outputs."""
        labels = []
        for layer in self.layers:
            feeding = []
            for _, lhs, rhs, _ in layer:
                feeding += [lhs, rhs]
            labels.append(list(dict.fromkeys(feeding)))
        labels.append([out for _, _, _, out in self.layers[-1]])
        return labels

    def evaluate(self, input_map: dict, modulus: int) -> Sequence[dict]:
        """Forward-evaluate every layer; returns one {wire: value} dict per
        layer, inputs first."""
        if set(input_map) != set(self.inputs):
            raise ValueError("Insufficient input values are supplied")

        values = dict(input_map)
        per_layer = [dict(input_map)]
        for layer in self.layers:
            outputs = {}
            for kind, lhs, rhs, out in layer:
                result = _GATE_OPS[kind](values[lhs], values[rhs], modulus)
                values[out] = result
                outputs[out] = result
            per_layer.append(outputs)
        return per_layer

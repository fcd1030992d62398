"""GKR protocol for layered arithmetic circuits (Thaler PAZK section 4.6).

Behavioral parity with upstream zksnake: python/zksnake/subprotocol/gkr.py:
identical transcript schedule, the reversed index packing of the wiring
selectors (so sumcheck's variable-by-variable fixing works in place, ref
gkr.py:155-163), and the restrict-to-line reduction from two claims to one.
Original implementation: ADD/MUL wiring extraction shares one walker, and
restrict-to-line folds the evaluation table iteratively (pairing adjacent
entries per variable) instead of recursing.

Copy of zksnake_tpu/subprotocol/gkr.py with the port's imports and a
`device` ("cuda" unless the caller asks for the CPU) carried into its
multilinear polynomials and sumchecks. Its wiring selectors add~/mul~ are
sparse (one entry a gate in a cube of 2^(a + 2b) points, as the reference
packs them: one variable a wire, a and b the wire counts of a layer and of
the layer below), so the density rule of backend/mle.py keeps their partial
evaluations on the host, as it does in the JAX package: GKR has no device
path of its own.
"""

from ..arithmetization import LayeredCircuit
from ..backend.config import check_device
from ..constant import BN254_SCALAR_FIELD
from ..polynomial import MultilinearPolynomial, Polynomial
from ..transcript import FiatShamirTranscript
from .sumcheck import Sumcheck, SumcheckPolynomial, univariate_round_poly


class GkrPolynomial(SumcheckPolynomial):
    """f(a,b,c) = add~(a,b,c) * (W(b) + W(c)) + mul~(a,b,c) * W(b) * W(c)."""

    def __init__(self, n, p, add_i, mul_i, w_b, w_c, device="cuda"):
        super().__init__(n, p)
        self.device = device
        self.add_i = add_i
        self.mul_i = mul_i
        self.w_b = w_b
        self.w_c = w_c

    def to_evaluations(self):
        add_tbl = self.add_i.to_evaluations()
        mul_tbl = self.mul_i.to_evaluations()
        w_b_tbl = self.w_b.to_evaluations()
        w_c_tbl = self.w_c.to_evaluations()
        shift = self.w_b.num_vars

        out = []
        for c_idx, w_c in enumerate(w_c_tbl):
            base = c_idx << shift
            for b_idx, w_b in enumerate(w_b_tbl):
                sel = base | b_idx
                if add_tbl[sel] or mul_tbl[sel]:
                    out.append(
                        (add_tbl[sel] * (w_b + w_c) + mul_tbl[sel] * w_b * w_c)
                        % self.p
                    )
        return out

    def partial_evaluate(self, points):
        split = self.w_b.num_vars
        return GkrPolynomial(
            self.n,
            self.p,
            self.add_i.partial_evaluate(points),
            self.mul_i.partial_evaluate(points),
            self.w_b.partial_evaluate(points[:split]),
            self.w_c.partial_evaluate(points[split:]),
            self.device,
        )

    def evaluate(self, points):
        assert len(points) == self.n
        fixed = self.partial_evaluate(points)
        add_v = fixed.add_i.to_evaluations()[0]
        mul_v = fixed.mul_i.to_evaluations()[0]
        w_b = fixed.w_b.to_evaluations()[0]
        w_c = fixed.w_c.to_evaluations()[0]
        return (add_v * (w_b + w_c) + mul_v * w_b * w_c) % self.p

    def first_round(self):
        return univariate_round_poly(self, self.p, self.device)

    def round_function(self, r):
        return univariate_round_poly(self.partial_evaluate(r), self.p, self.device)


class GKR:
    """Prove/verify the evaluation of a low-depth layered circuit."""

    def __init__(self, circuit: LayeredCircuit, field=BN254_SCALAR_FIELD, device="cuda"):
        self.circuit = circuit
        self.order = field
        self.device = check_device(device)
        self.depth = len(circuit.layers)
        # output layer first, inputs last
        self.wire_labels = self.circuit.get_wire_label()[::-1]

    def _gate_triples(self, layer_idx, kind):
        """(gate index, left input index, right input index) for every gate
        of `kind` ("ADD"/"MUL") in layer `layer_idx` (output-first order)."""
        layer = self.circuit.layers[::-1][layer_idx]
        below = self.wire_labels[layer_idx + 1]
        return [
            (pos, below.index(lhs), below.index(rhs))
            for pos, (gate_kind, lhs, rhs, _) in enumerate(layer)
            if gate_kind == kind
        ]

    def _selector_polynomial(self, layer_idx, r):
        """Wiring MLEs add~ / mul~ with variables packed (c, b, a) — reversed
        so partial evaluation fixes `a` (the already-challenged layer index)
        first, in place."""
        bits_a = len(self.wire_labels[layer_idx])
        bits_bc = len(self.wire_labels[layer_idx + 1])
        total_vars = bits_a + 2 * bits_bc

        def packed(kind):
            return [
                ((c << (bits_bc + bits_a)) + (b << bits_a) + a, 1)
                for a, b, c in self._gate_triples(layer_idx, kind)
            ]

        add_ext = MultilinearPolynomial(total_vars, packed("ADD"), self.order, self.device)
        mul_ext = MultilinearPolynomial(total_vars, packed("MUL"), self.order, self.device)
        return add_ext.partial_evaluate(r), mul_ext.partial_evaluate(r)

    def _layer_polynomial(self, evaluation_layers, layer_idx, r):
        """The layer's sumcheck polynomial f(b, c) with a already fixed to r."""
        below = self.wire_labels[layer_idx + 1]
        w_evals = [
            (pos, evaluation_layers[layer_idx + 1][label])
            for pos, label in enumerate(below)
        ]
        add_ext, mul_ext = self._selector_polynomial(layer_idx, r)
        w_next = MultilinearPolynomial(len(below), w_evals, self.order, self.device)
        return GkrPolynomial(
            add_ext.num_vars, self.order, add_ext, mul_ext, w_next, w_next, self.device
        )

    def _init_transcript(self, input_map, outputs, transcript=None):
        transcript = transcript or FiatShamirTranscript(b"gkr", field=self.order)
        for value in input_map.values():
            transcript.append(value)
        for _, value in outputs:
            transcript.append(value)
        return transcript

    def _restrict_to_line(self, w, b, c):
        """Univariate q(t) = W(l(t)) for the line l(t) = b + (c - b) t.

        Iterative fold: start from the full evaluation table (constant
        polynomials) and, per variable from last to first, combine adjacent
        pairs as lo + (hi - lo) * (b_i + k_i t)."""
        n = w.num_vars
        assert len(b) == n and len(c) == n
        k = [(cv - bv) % self.order for bv, cv in zip(b, c)]

        polys = [Polynomial([e], self.order) for e in w.to_evaluations()]
        for idx in range(n - 1, -1, -1):
            line_i = Polynomial([b[idx], k[idx]], self.order)
            polys = [
                lo + (hi - lo) * line_i
                for lo, hi in zip(polys[0::2], polys[1::2])
            ]
        return polys[0]

    def _reduce_two_claims(self, f, challenges, transcript, proof):
        """Restrict W to the line through (b, c), emit q and its endpoints,
        then collapse to a single claim at a fresh challenge."""
        half = f.n // 2
        b, c = challenges[:half], challenges[half:]
        line = [
            Polynomial([bv, (cv - bv) % self.order], self.order)
            for bv, cv in zip(b, c)
        ]
        q = self._restrict_to_line(f.w_b, b[::-1], c[::-1])
        z1, z2 = q(0), q(1)

        for uni in proof:
            transcript.append(uni.coeffs())
        transcript.append(q.coeffs())
        transcript.append([z1, z2])

        t = transcript.get_challenge_scalar()
        return q, z1, z2, q(t), [p(t) for p in line]

    def prove(self, input_map: dict, transcript=None):
        """Evaluate the circuit and prove each layer via sumcheck."""
        evaluation_layers = self.circuit.evaluate(input_map, self.order)[::-1]
        outputs = list(enumerate(evaluation_layers[0].values()))
        n_out = len(outputs)
        w_0 = MultilinearPolynomial(max(1, n_out), outputs, self.order, self.device)

        transcript = self._init_transcript(input_map, outputs, transcript)
        r = [transcript.get_challenge_scalar() for _ in range(n_out)]
        m = w_0.evaluate(r)

        sumcheck_proofs = []
        for layer_idx in range(self.depth):
            f = self._layer_polynomial(evaluation_layers, layer_idx, r)
            claim, proof, challenges = Sumcheck(f.n, self.order, self.device).prove_arbitrary(
                f, transcript
            )
            assert claim == m, "Wiring pattern of the circuit might be incorrect"

            q, z1, z2, next_m, next_r = self._reduce_two_claims(
                f, challenges, transcript, proof
            )

            # internal consistency: the final round ties to W(b), W(c)
            w_pair = (
                f.add_i.evaluate(challenges) * (z1 + z2)
                + f.mul_i.evaluate(challenges) * (z1 * z2)
            ) % self.order
            assert w_pair == proof[-1](challenges[-1])
            assert f.w_b.evaluate(next_r) == next_m

            proof.append((q, z1, z2))
            sumcheck_proofs.append(proof)
            m, r = next_m, next_r

        return evaluation_layers[0], sumcheck_proofs

    def verify(self, input_map: dict, output_map: dict, proofs: list,
               transcript=None) -> bool:
        outputs = list(enumerate(output_map.values()))
        n_out = len(outputs)
        w_0 = MultilinearPolynomial(max(1, n_out), outputs, self.order, self.device)

        transcript = self._init_transcript(input_map, outputs, transcript)
        r = [transcript.get_challenge_scalar() for _ in range(n_out)]
        m = w_0.evaluate(r)

        for layer_idx in range(self.depth):
            add_ext, mul_ext = self._selector_polynomial(layer_idx, r)
            half = add_ext.num_vars // 2

            round_proof = proofs[layer_idx]
            challenges = Sumcheck(add_ext.num_vars, self.order, self.device).verify(
                m, round_proof[:-1], 2, transcript
            )
            if not challenges:
                return False

            b, c = challenges[:half], challenges[half:]
            line = [
                Polynomial([bv, (cv - bv) % self.order], self.order)
                for bv, cv in zip(b, c)
            ]
            q, z1, z2 = round_proof[-1]
            if q(0) != z1 or q(1) != z2:
                return False

            w_pair = (
                add_ext.evaluate(challenges) * (z1 + z2)
                + mul_ext.evaluate(challenges) * (z1 * z2)
            ) % self.order
            if w_pair != round_proof[-2](challenges[-1]):
                return False

            for uni in round_proof[:-1]:
                transcript.append(uni.coeffs())
            transcript.append(q.coeffs())
            transcript.append([z1, z2])

            t = transcript.get_challenge_scalar()
            m = q(t)
            r = [p(t) for p in line]

        inputs = list(enumerate(input_map.values()))
        w_in = MultilinearPolynomial(len(inputs), inputs, self.order, self.device)
        return w_in.evaluate(r) == m

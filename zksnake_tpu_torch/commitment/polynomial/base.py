"""Polynomial-commitment interface + batched-opening query bookkeeping.

Role parity with upstream zksnake: python/zksnake/commitment/polynomial/base.py:
`MultiOpeningQuery` tracks which polynomial (prover side) or commitment
(verifier side) is opened at which point, in query order. The storage here is
a single indexed table rather than the reference's parallel lists, but the
iteration order (points in first-query order, polys in per-point query order)
is identical, which is what the multi-open transcripts depend on.

Copy of zksnake_tpu/commitment/polynomial/base.py with the port's imports.
"""

from abc import ABC, abstractmethod

from ...polynomial import lagrange_interpolation
from ...transcript import FiatShamirTranscript


class MultiOpeningQuery:
    def __init__(self):
        self.polynomials = []
        self.commitments = []
        self.blindings = []
        # point -> [registered index, ...] in query order
        self.opening_points = {}
        # point -> {registered index: evaluation}
        self.evaluations = {}

    @staticmethod
    def _index(table, item, register=False):
        """Equality-based index lookup, optionally appending unseen items."""
        for i, existing in enumerate(table):
            if existing == item:
                return i
        if not register:
            raise ValueError("unknown query item")
        table.append(item)
        return len(table) - 1

    def _record(self, index, point, evaluation):
        self.opening_points.setdefault(point, []).append(index)
        self.evaluations.setdefault(point, {})[index] = evaluation

    def add_polynomial(self, polynomial, commitment, blinding=None):
        """Register a (polynomial, commitment) pair before querying it.
        A falsy blinding registers as 1 (unblinded)."""
        for existing in self.polynomials:
            if existing == polynomial:
                return
        self.polynomials.append(polynomial)
        self.commitments.append(commitment)
        self.blindings.append(blinding or 1)

    def prover_query(self, polynomial, point):
        """Prover side: evaluate and record an opening of `polynomial` at
        `point` (registers the polynomial if unseen)."""
        idx = self._index(self.polynomials, polynomial, register=True)
        self._record(idx, point, polynomial(point))

    def verifier_query(self, commitment, point, evaluation):
        """Verifier side: record a claimed evaluation for `commitment`."""
        idx = self._index(self.commitments, commitment, register=True)
        self._record(idx, point, evaluation)

    def to_polynomial(self, commitment):
        return self.polynomials[self._index(self.commitments, commitment)]

    def to_commitment(self, polynomial):
        return self.commitments[self._index(self.polynomials, polynomial)]

    def get_blinding(self, commitment):
        return self.blindings[self._index(self.commitments, commitment)]

    def get_evaluation(self, commitment, point):
        return self.evaluations[point][self._index(self.commitments, commitment)]

    def get_polynomials(self):
        """Yield (point, [polynomials opened there]) in query order."""
        for point, indices in self.opening_points.items():
            yield point, [self.polynomials[i] for i in indices]

    def get_commitments(self):
        """Yield (point, [commitments opened there]) in query order."""
        for point, indices in self.opening_points.items():
            yield point, [self.commitments[i] for i in indices]


def group_by_opening_sets(query: MultiOpeningQuery):
    """Partition queried commitments by the SET of points each is opened at.

    Returns [(points, members), ...] where `points` dedupes in query order and
    `members` lists the group's commitments in first-seen order. Both the
    prover and the verifier derive this from their own query object; the
    deterministic ordering is what keeps their challenge folds aligned.
    (The reference's analogue walks Python sets — hash order — instead.)
    """
    opened_at = {}
    for point, comms in query.get_commitments():
        for comm in comms:
            pts = opened_at.setdefault(comm, [])
            if point not in pts:
                pts.append(point)
    groups = {}
    order = []
    for comm, pts in opened_at.items():
        key = frozenset(pts)
        if key not in groups:
            groups[key] = (list(pts), [])
            order.append(key)
        else:
            for p in pts:
                if p not in groups[key][0]:
                    groups[key][0].append(p)
        groups[key][1].append(comm)
    return [groups[k] for k in order]


class PolynomialCommitmentScheme(ABC):
    def __init__(self, max_degree, group):
        self.degree = max_degree
        self.group = group
        self.order = None
        self.name = ""
        self.is_setup = False

    def list_to_poly(self, values):
        """Interpolate `values` at x = 0..len-1 into a polynomial."""
        if len(values) > self.degree:
            raise ValueError("too many values for the committed degree")
        return lagrange_interpolation(list(range(len(values))), values, self.order)

    @abstractmethod
    def zero_commitment(self):
        ...

    @abstractmethod
    def setup(self):
        ...

    @abstractmethod
    def commit(self, polynomial):
        ...

    @abstractmethod
    def open(self, polynomial, point):
        ...

    @abstractmethod
    def verify(self, commitment, proof, point, evaluation, transcript=None):
        ...

    @abstractmethod
    def multi_open(
        self, points_query: MultiOpeningQuery, transcript: FiatShamirTranscript = None
    ):
        ...

    @abstractmethod
    def multi_verify(
        self,
        points_query: MultiOpeningQuery,
        proof: list,
        transcript: FiatShamirTranscript = None,
    ):
        ...

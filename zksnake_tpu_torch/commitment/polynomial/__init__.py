from .kzg import KZG
from .ipa import IPA
from .base import MultiOpeningQuery, PolynomialCommitmentScheme

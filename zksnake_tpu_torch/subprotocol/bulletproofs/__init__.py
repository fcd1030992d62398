from .ipa import InnerProductArgument, InnerProductProof
from .range_proof import RangeProof

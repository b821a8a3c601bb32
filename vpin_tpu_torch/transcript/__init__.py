from .keccak import keccak_f1600, sha3_256
from .merlin import RandomTape, Transcript
from .strobe import Strobe128

__all__ = ["keccak_f1600", "sha3_256", "Strobe128", "Transcript", "RandomTape"]

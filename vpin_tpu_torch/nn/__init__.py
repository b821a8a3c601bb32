from .elgamal import CipherTensor, KeyPair, encrypt_batch
from .homomorphic import HomomorphicEngine, RLCCheckError
from .models import CONV_FILTERS, WorkloadResult, run_conv_workload
from .trace import WitnessTrace

__all__ = [
    "CONV_FILTERS", "CipherTensor", "HomomorphicEngine", "KeyPair",
    "RLCCheckError", "WitnessTrace", "WorkloadResult", "encrypt_batch",
    "run_conv_workload",
]

from .bsgs import BsgsTable
from .elgamal import CipherTensor, KeyPair, decrypt_batch, encrypt_batch
from .homomorphic import HomomorphicEngine, RLCCheckError, channel_sum
from .models import (
    CNN_CONFIGS, CONV_FILTERS, WorkloadResult, run_cnn_workload,
    run_conv_workload, run_lenet_workload,
)
from .trace import WitnessTrace

__all__ = [
    "BsgsTable", "CNN_CONFIGS", "CONV_FILTERS", "CipherTensor",
    "HomomorphicEngine", "KeyPair", "RLCCheckError", "WitnessTrace",
    "WorkloadResult", "channel_sum", "decrypt_batch", "encrypt_batch",
    "run_cnn_workload", "run_conv_workload", "run_lenet_workload",
]

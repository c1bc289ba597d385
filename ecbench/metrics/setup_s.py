"""setup_s (end to end, host clock): from the process's start to the first
timed call: imports, the CUDA context, the encoder and its kernels loaded
from the checkout's build directory, the inputs made, the cell's shapes
warmed."""


def read(rec):
    return rec["setup_s"]

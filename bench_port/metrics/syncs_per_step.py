"""syncs_per_step: CUDA runtime calls that block the host on the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) inside each traced ``dodt/train_step``, per
step (harness/spans.py)."""
from harness.spans import syncs_per_call


def read(r):
    return syncs_per_call(r)

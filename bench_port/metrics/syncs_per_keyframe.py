"""syncs_per_keyframe: CUDA runtime calls that block the host on the
device (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) inside each traced call's root span, per call
(harness/spans.py)."""
from harness.spans import syncs_per_call


def read(r):
    return syncs_per_call(r)

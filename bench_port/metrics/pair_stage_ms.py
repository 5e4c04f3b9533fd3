"""pair_stage_ms: mean ms from the synced end of encode_frame to the
detections on the host: the warp into the previous keyframe's frame,
the pair stage (correlation, second stage, NMS) and the fetch."""


def read(r):
    return r.mean_span_ms("pair_stage")

"""encode_ms: mean ms of the synced span around the model's
encode_frame (towers, RPN, NMS) in the traced run's span stretch."""


def read(r):
    return r.mean_span_ms("encode_frame")

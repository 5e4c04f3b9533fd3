"""The benchmark's plain reference: plain PyTorch in float32 with TF32
off and no hand-written kernel, a frozen copy of the plain path of
``dodt_tpu_torch`` (the model's forward in val and train mode, its
losses, the streaming warp and the Adam step). It imports nothing of
``dodt_tpu_torch`` or of the JAX package, and takes nothing the program
made: the benchmark hands it the weights, inputs and draws it made."""

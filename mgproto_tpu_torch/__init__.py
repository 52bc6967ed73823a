"""MGProto in PyTorch for NVIDIA Hopper (H100).

A second package beside the JAX reference `mgproto_tpu`: the same model,
module for module, with hand-written CUDA kernels where the JAX package has
Pallas kernels. It imports `torch` and nothing of JAX or of `mgproto_tpu`.

Entry points (`core.mgproto.build_mgproto`, `engine.eval.Evaluator`,
`serving.engine.ServingEngine.from_live`) run on the GPU unless the caller
passes `device="cpu"`; with no device given and no CUDA device present they
raise.
"""

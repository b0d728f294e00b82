"""signalsmith-stretch offline rendering in PyTorch, with hand-written CUDA
kernels for Hopper (csrc/).

`models.StretchModel.build(...).batched(clips)` renders a batch of clips on
the card (device="cuda", the default) or, when asked for, on the CPU with
the plain PyTorch versions of the kernels.
"""

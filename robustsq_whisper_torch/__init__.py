"""PyTorch / CUDA port of the target-speaker Whisper serving path.

A second package beside the JAX reference: it imports ``torch``, numpy and
the standard library, never JAX. Module paths mirror the JAX package so each
module's counterpart is easy to find. Public entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, which takes
every kernel's plain PyTorch version instead.
"""

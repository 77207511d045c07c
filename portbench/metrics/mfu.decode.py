"""The model step's share of the card's peak, in %: model FLOPs of every
token the window's steps processed (``work.model_flops``) over the window
and the peak of the type the products run in (bf16 989 TFLOP/s, float32
with TF32 off 67 TFLOP/s)."""

from portbench.readers import step_mfu as read  # noqa: F401

"""Entry points of the port that no model path calls (``python -m
class_query_vad_tpu_torch.scripts.<name>``)."""

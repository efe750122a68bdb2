from .melhubert import MelHuBERTModel, melhubert_forward

__all__ = ["MelHuBERTModel", "melhubert_forward"]

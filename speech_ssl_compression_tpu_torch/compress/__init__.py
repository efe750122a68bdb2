"""Compression of the port's models (weight pruning so far; head and row
pruning and distillation are not ported, ROADMAP.md Queue 1)."""

from .schedule import set_prune_interval, sparsity_ladder, weight_prune_steps
from . import weight_pruning

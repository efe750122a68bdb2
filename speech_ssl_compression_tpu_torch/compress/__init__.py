"""Compression of the port's models: weight, head and row pruning
(distillation is not ported, ROADMAP.md Queue 1)."""

from .schedule import set_prune_interval, sparsity_ladder, weight_prune_steps
from . import head_pruning, row_pruning, weight_pruning

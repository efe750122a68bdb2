"""Compression of the port's models: weight, head and row pruning and
knowledge distillation."""

from .schedule import set_prune_interval, sparsity_ladder, weight_prune_steps
from . import distillation, head_pruning, row_pruning, weight_pruning

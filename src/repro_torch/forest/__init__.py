"""repro_torch.forest — the random-forest substrate the paper assumes, the
port of ``repro.forest``: histogram CART grown and traversed with torch
on an explicit device; binning, baselines and the compact-tree conversion
are host numpy copies."""

from .baselines import light_compress, light_report, standard_compress
from .binning import Binner, fit_binner
from .cart import CartConfig, grow_tree
from .forest import (
    ForestModel,
    per_tree_predictions,
    predict_forest,
    to_compact_forest,
    train_forest,
)

__all__ = [
    "Binner",
    "CartConfig",
    "ForestModel",
    "fit_binner",
    "grow_tree",
    "light_compress",
    "light_report",
    "per_tree_predictions",
    "predict_forest",
    "standard_compress",
    "to_compact_forest",
    "train_forest",
]

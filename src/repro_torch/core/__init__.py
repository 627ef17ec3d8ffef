"""repro_torch.core — the paper's codec in the port: lossless compression
of random forests via probabilistic modeling + Bregman model clustering +
entropy coding, with prediction from the compressed format, and the §7
lossy knobs.  Host numpy copies of ``repro.core``, except the dense
Bregman step and the batched compressed-predict traversal, which run as
torch on an explicit device."""

from .arithmetic import ArithmeticCode
from .bregman import ClusteringResult, cluster_models, kl_assign, kl_kmeans
from .compressed_predict import iter_trees, predict_compressed
from .forest_codec import CompressedForest, compress_forest, decompress_forest
from .huffman import HuffmanCode, entropy_bits
from .lossy import (
    LossyTheory,
    estimate_sigma2,
    estimate_sigma2_per_obs,
    quantize_fits,
    subsample_trees,
)
from .lz import lzw_decode_bits, lzw_encode_bits
from .tree import Forest, ForestMeta, Tree
from .zaks import zaks_decode, zaks_encode, zaks_is_valid

__all__ = [
    "ArithmeticCode",
    "ClusteringResult",
    "CompressedForest",
    "Forest",
    "ForestMeta",
    "HuffmanCode",
    "LossyTheory",
    "Tree",
    "cluster_models",
    "compress_forest",
    "decompress_forest",
    "entropy_bits",
    "estimate_sigma2",
    "estimate_sigma2_per_obs",
    "iter_trees",
    "kl_assign",
    "kl_kmeans",
    "lzw_decode_bits",
    "lzw_encode_bits",
    "predict_compressed",
    "quantize_fits",
    "subsample_trees",
    "zaks_decode",
    "zaks_encode",
    "zaks_is_valid",
]

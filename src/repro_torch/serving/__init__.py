"""repro_torch.serving — the serving session API, ported.

``ForestServer`` serves predictions straight from the compressed format
(paper §5) on one explicit device: it owns the store, its device
``TileArena``, the decoded ``TileCache``, and a cross-batch plan cache,
and splits every request batch into a plan/execute IR —

    server = ForestServer(store, device="cuda")   # fleet ForestStore
    server = ForestServer.from_forest(comp, device="cuda")  # one forest
    plan = server.plan(requests)          # grouping + cost-model engine
    preds = server.execute(plan, X)       # pack -> gather -> kernel ->
                                          # finalize

``serve_safe`` is the fault-isolating variant.
``core.compressed_predict.predict_compressed`` is the decode-side oracle
every engine is verified against.
"""

from .cache import PlanCache
from .pack import iter_heap_tiles, pad_heap_width, tree_to_heap
from .plan import ENGINE_BLOCKS, EngineChoice, ServePlan, choose_engine
from .server import ForestServer, RequestStatus, SingleForestStore

__all__ = [
    "ENGINE_BLOCKS",
    "EngineChoice",
    "ForestServer",
    "PlanCache",
    "RequestStatus",
    "ServePlan",
    "SingleForestStore",
    "choose_engine",
    "iter_heap_tiles",
    "pad_heap_width",
    "tree_to_heap",
]

"""Meshes over ``torch.distributed`` (counterpart of ``multimodal_colpali_tpu/parallel``)."""

from multimodal_colpali_tpu_torch.parallel.mesh import (  # noqa: F401
    CorpusShard, Mesh, Sharding, all_gather, all_reduce, batch_sharding, broadcast_object,
    copy_to_model, gather_rows, get_mesh, global_corpus_mesh, initialize_distributed,
    make_global_corpus, rank_rows, reduce_from_model, replicate, shard_params_for_tp,
    shard_range, tp_head_plan)

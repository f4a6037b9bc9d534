"""Operational utilities (counterpart of ``multimodal_colpali_tpu/utils``):
endpoint health (``health``), device housekeeping on ``torch.cuda``
(``housekeeping``), tabular IO (``io``, pandas) and the multi-user helpers
(``userops``). Only ``io`` needs pandas; the others run on the GPU host,
which has none.
"""

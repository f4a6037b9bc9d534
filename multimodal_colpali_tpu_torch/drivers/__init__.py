"""The drivers as the port's entry points (counterparts of
``drivers/01_create_context.py``, ``02a_stat_test.py``,
``04_experiment01_eval.py`` and ``06_experiment02_eval.py``), as ``serve.py``
stands for ``07_serve.py``:

    python -m multimodal_colpali_tpu_torch.drivers.create_context --papers-dir ...
    python -m multimodal_colpali_tpu_torch.drivers.stat_test --input ...
    python -m multimodal_colpali_tpu_torch.drivers.experiment01_eval ...
    python -m multimodal_colpali_tpu_torch.drivers.experiment02_eval ...

Each takes its driver's flags and writes the same artifacts.
``create_context`` (ingest and indexing) runs on the card by default; the
evaluation drivers are pandas code and read results offline: nothing the GPU
host serves with imports them.
"""

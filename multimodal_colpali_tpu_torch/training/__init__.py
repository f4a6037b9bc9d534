from multimodal_colpali_tpu_torch.training.trainer import (  # noqa: F401
    colbert_loss,
    colbert_scores,
    make_train_step,
    make_training_setup,
)

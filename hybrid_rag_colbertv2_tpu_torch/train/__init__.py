from .trainer import ColBERTTrainer, TrainConfig, make_train_step  # noqa: F401
from .data import pseudo_query_pairs  # noqa: F401

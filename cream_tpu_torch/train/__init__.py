from cream_tpu_torch.train.metrics import AverageMeter, MetricLogger, topk_accuracy_counts
from cream_tpu_torch.train.optim import cosine_schedule, make_adamw, make_sgd
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_eval_step, make_train_step

from aurora_tpu_torch.eval.api import Task, TaskConfig, register_task, get_task
from aurora_tpu_torch.eval.evaluator import simple_evaluate

__all__ = ["Task", "TaskConfig", "register_task", "get_task",
           "simple_evaluate"]

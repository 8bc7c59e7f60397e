"""The task zoo and the lmms-eval YAML loader on the port's copies
(aurora_tpu_torch/eval/tasks/, eval/yaml_task.py): every case of the
reference's tests/test_task_zoo.py and tests/test_yaml_task.py, run on
the port (their source with the JAX package's eval modules replaced by
the port's and AuroraCapEval on the CPU in float32; see
test_torch_eval.port_cases), so the copies meet the same expectations as
the originals: prompts, parsers, per-doc results and aggregations, the
catalog, and the e2e runs through the port's evaluator and adapter.
"""

from test_torch_eval import port_cases

exec(port_cases("test_task_zoo.py"))
exec(port_cases("test_yaml_task.py"))

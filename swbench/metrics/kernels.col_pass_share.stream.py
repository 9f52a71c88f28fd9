"""kernels.col_pass_share.stream: ``kernels.col_pass_share``'s reading in
the cells whose end-to-end metric is ``query_mean_ms`` (a streamed
database), where the col kernels' passes move the query time, not
``gcups``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "swbench_metric_kernels.col_pass_share", Path(__file__).with_name("kernels.col_pass_share.py"))
_share = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_share)
read = _share.read

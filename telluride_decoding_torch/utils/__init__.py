"""Host helpers: results, CSV, stage timing, device traces, TensorBoard
events (port of telluride_decoding_tpu/utils)."""

from telluride_decoding_torch.utils.csv_util import (
    read_all_results_from_directory,
    write_results,
)
from telluride_decoding_torch.utils.summaries import SummaryWriter
from telluride_decoding_torch.utils.profiling import (
    StageTimer,
    timed_block,
    trace,
)
from telluride_decoding_torch.utils.results import (
    best_parameter,
    collect_sweep_results,
    parse_results_file,
)
from telluride_decoding_torch.utils.stats_bounds import (
    BoundViolation,
    GoldenResults,
    check_within_bounds,
)

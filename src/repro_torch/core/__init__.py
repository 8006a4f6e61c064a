"""The paper's primary contribution: GPTQT two-step quantization, its
baselines, and the calibration/quantize-model machinery (the reference's
`core/`)."""
from repro_torch.core.api import (collect_hessians, eligible_paths,
                                  quantize_matrix, quantize_model)
from repro_torch.core.binary_coding import (bcq_alternating, bcq_greedy,
                                            bcq_levels, enumerate_bc_choices)
from repro_torch.core.gptq import gptq_solve, gptq_solve_refresh, output_error
from repro_torch.core.gptqt import gptqt_quantize
from repro_torch.core.hessian import (HessianAccumulator, damp,
                                      hessian_from_inputs)
from repro_torch.core.rtn import (group_rows, linear_levels, minmse_grid,
                                  n_k_groups, quantize_rtn, row_grid)
from repro_torch.core.stages import StageTimer

__all__ = [
    "quantize_model", "quantize_matrix", "collect_hessians",
    "eligible_paths", "gptqt_quantize", "gptq_solve",
    "gptq_solve_refresh", "output_error",
    "bcq_greedy", "bcq_alternating", "bcq_levels", "enumerate_bc_choices",
    "HessianAccumulator", "hessian_from_inputs", "damp", "quantize_rtn",
    "row_grid", "linear_levels", "minmse_grid", "group_rows", "n_k_groups",
    "StageTimer",
]

from .compute_model import ComputeModel, calibrate_host_flops, prefill_flops  # noqa: F401
from .engine import EngineStats, RequestRecord, ServingEngine  # noqa: F401

from .ops import (  # noqa: F401
    adamw_update,
    adamw_update_ref,
    factored_stats,
    factored_stats_ref,
    sq_norm_ref,
    sq_norms,
)

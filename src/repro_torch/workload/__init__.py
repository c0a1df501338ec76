from .staged import (  # noqa: F401
    PAPER_STAGES,
    MultiTenantWorkload,
    Request,
    StagedWorkload,
)

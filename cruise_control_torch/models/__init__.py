from cruise_control_torch.models.flat_model import (  # noqa: F401
    FlatClusterModel,
    from_numpy,
    sanity_check,
    to_numpy,
)

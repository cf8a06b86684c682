from cruise_control_torch.config.balancing import BalancingConstraint  # noqa: F401
from cruise_control_torch.config.configdef import (  # noqa: F401
    AbstractConfig,
    ConfigDef,
    ConfigException,
    load_properties,
)
from cruise_control_torch.config.cruise_config import (  # noqa: F401
    ANOMALY_DETECTION_GOALS,
    DEFAULT_GOALS,
    HARD_GOALS,
    CruiseControlConfig,
)

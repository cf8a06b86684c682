"""Kafka-style typed configuration framework.

Re-creates the behavior of the reference's config core
(core/common/config/ConfigDef.java + AbstractConfig.java): a registry of typed
keys with defaults, range/choice validators, importance levels and docs; parsing
from dicts or .properties files; and reflection-based plug-in instantiation
(`AbstractConfig.getConfiguredInstance`) used to load goals, samplers, sample
stores, notifiers and movement strategies by class path.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional


class ConfigException(ValueError):
    """Mirrors core/common/config/ConfigException.java."""


class Type(enum.Enum):
    BOOLEAN = "boolean"
    STRING = "string"
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    LIST = "list"
    CLASS = "class"
    PASSWORD = "password"


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class Password:
    """Opaque wrapper so secrets never repr into logs (core ConfigDef.Password)."""

    def __init__(self, value: str):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "[hidden]"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Password) and other.value == self.value

    def __hash__(self) -> int:
        return hash(self.value)


#: Sentinel for keys with no default (required keys).
NO_DEFAULT = object()


def at_least(minimum) -> Callable[[str, Any], None]:
    def validate(name: str, value) -> None:
        if value is not None and value < minimum:
            raise ConfigException(f"{name} must be at least {minimum}, got {value}")

    return validate


def between(lo, hi) -> Callable[[str, Any], None]:
    def validate(name: str, value) -> None:
        if value is not None and not (lo <= value <= hi):
            raise ConfigException(f"{name} must be in [{lo}, {hi}], got {value}")

    return validate


def in_choices(choices: Iterable[str]) -> Callable[[str, Any], None]:
    allowed = set(choices)

    def validate(name: str, value) -> None:
        if value is not None and value not in allowed:
            raise ConfigException(f"{name} must be one of {sorted(allowed)}, got {value}")

    return validate


@dataclasses.dataclass
class ConfigKey:
    name: str
    type: Type
    default: Any
    validator: Optional[Callable[[str, Any], None]]
    importance: Importance
    doc: str

    @property
    def has_default(self) -> bool:
        return self.default is not NO_DEFAULT


class ConfigDef:
    """Registry of config keys; `parse` turns raw strings into typed values."""

    def __init__(self) -> None:
        self._keys: Dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        type: Type,
        default: Any = NO_DEFAULT,
        validator: Optional[Callable[[str, Any], None]] = None,
        importance: Importance = Importance.MEDIUM,
        doc: str = "",
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"Config key {name} is defined twice")
        if default is not NO_DEFAULT and default is not None:
            default = _parse_value(name, type, default)
        self._keys[name] = ConfigKey(name, type, default, validator, importance, doc)
        return self

    def keys(self) -> Mapping[str, ConfigKey]:
        return self._keys

    def parse(self, props: Mapping[str, Any]) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = _parse_value(name, key.type, props[name])
            elif key.has_default:
                value = key.default
            else:
                raise ConfigException(f"Missing required configuration '{name}'")
            if key.validator is not None:
                key.validator(name, value)
            values[name] = value
        return values


def _parse_value(name: str, type: Type, value: Any) -> Any:
    try:
        if value is None:
            return None
        if type is Type.BOOLEAN:
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s not in ("true", "false"):
                raise ConfigException(f"{name}: expected boolean, got {value!r}")
            return s == "true"
        if type is Type.STRING:
            return str(value).strip()
        if type is Type.INT or type is Type.LONG:
            return int(str(value).strip())
        if type is Type.DOUBLE:
            return float(str(value).strip())
        if type is Type.LIST:
            if isinstance(value, (list, tuple)):
                return list(value)
            s = str(value).strip()
            return [item.strip() for item in s.split(",") if item.strip()] if s else []
        if type is Type.CLASS:
            return str(value).strip()
        if type is Type.PASSWORD:
            return value if isinstance(value, Password) else Password(str(value))
    except ConfigException:
        raise
    except (TypeError, ValueError) as e:
        raise ConfigException(f"Invalid value {value!r} for configuration {name}: {e}") from e
    raise ConfigException(f"Unknown type {type} for configuration {name}")


def load_properties(path: str) -> Dict[str, str]:
    """Parse a Java-style .properties file (the reference's config format)."""
    props: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        pending = ""
        for raw in f:
            line = pending + raw.strip()
            pending = ""
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            if line.endswith("\\"):
                pending = line[:-1]
                continue
            _store_property(props, line)
        if pending:
            _store_property(props, pending)
    return props


def _store_property(props: Dict[str, str], line: str) -> None:
    for sep in ("=", ":"):
        idx = _unescaped_index(line, sep)
        if idx >= 0:
            props[line[:idx].strip()] = line[idx + 1 :].strip()
            return
    props[line.strip()] = ""


def _unescaped_index(line: str, sep: str) -> int:
    idx = -1
    start = 0
    while True:
        idx = line.find(sep, start)
        if idx <= 0 or line[idx - 1] != "\\":
            return idx
        start = idx + 1


class AbstractConfig:
    """Typed view over parsed values + plug-in loading.

    Mirrors core/common/config/AbstractConfig.java: `get_*` typed accessors,
    `originals` passthrough for unknown keys (handed to plug-ins on configure),
    and `get_configured_instance` reflection loading.
    """

    def __init__(self, definition: ConfigDef, props: Mapping[str, Any]):
        self._definition = definition
        self._originals = dict(props)
        self._values = definition.parse(props)
        self._used: set = set()

    def originals(self) -> Dict[str, Any]:
        return dict(self._originals)

    def _get(self, name: str):
        if name not in self._values:
            raise ConfigException(f"Unknown configuration '{name}'")
        self._used.add(name)
        return self._values[name]

    def get(self, name: str):
        return self._get(name)

    def get_boolean(self, name: str) -> bool:
        return self._get(name)

    def get_int(self, name: str) -> int:
        return self._get(name)

    def get_long(self, name: str) -> int:
        return self._get(name)

    def get_double(self, name: str) -> float:
        return self._get(name)

    def get_string(self, name: str) -> str:
        return self._get(name)

    def get_list(self, name: str) -> List[str]:
        value = self._get(name)
        return list(value) if value is not None else []

    def unused(self) -> List[str]:
        """Supplied keys never read through an accessor (Kafka AbstractConfig
        semantics: originals minus used, regardless of being defined)."""
        return sorted(set(self._originals) - self._used)

    def get_configured_instance(self, name: str, expected_type: type):
        """Instantiate the class named by config key `name` and configure it."""
        class_path = self._get(name)
        return self.instantiate(class_path, expected_type)

    def get_configured_instances(self, name: str, expected_type: type) -> List[Any]:
        return [self.instantiate(cp, expected_type) for cp in self.get_list(name)]

    def instantiate(self, class_path: str, expected_type: type):
        cls = resolve_class(class_path)
        if not (isinstance(cls, type) and issubclass(cls, expected_type)):
            raise ConfigException(
                f"{class_path} is not a subclass of {expected_type.__name__}"
            )
        instance = cls()
        configure = getattr(instance, "configure", None)
        if callable(configure):
            configure(self.originals())
        return instance


def resolve_class(class_path: str):
    """Import `pkg.module.Class` (reflection-style plug-in loading)."""
    module_name, _, cls_name = class_path.rpartition(".")
    if not module_name:
        raise ConfigException(f"Invalid class path {class_path!r}")
    try:
        module = importlib.import_module(module_name)
        return getattr(module, cls_name)
    except (ImportError, AttributeError) as e:
        raise ConfigException(f"Could not load class {class_path!r}: {e}") from e

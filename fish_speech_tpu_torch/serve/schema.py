"""The API's request and response schemas, as plain dataclasses.

Counterpart of `fish_speech_tpu/serve/schema.py`, whose pydantic models
mirror the reference's (fish_speech/utils/schema.py:42-138). Each request
class has a `from_dict` that validates a decoded JSON or msgpack body as
pydantic v2 validates it for these models (python mode): defaults; the
`Literal`s; lax int, bool, str and bytes (an int from an integral float or
a numeric string, a bool from 0/1 or yes/no words, str and bytes from each
other through utf-8); the `strict=True` float ranges (an int is taken, a
bool or a string is not); the id pattern and lengths; `ServeReferenceAudio`
decoding a base64 string over 255 characters; nested references. Unknown
keys are ignored. A failure raises `ValidationError` (a ValueError) whose
`errors()` lists what pydantic's would: type, loc, msg and ctx per field,
in field order.
"""

from __future__ import annotations

import base64
import re
from dataclasses import MISSING, dataclass, field, fields

_MISSING = object()
_INT_RE = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*")
_INT_DOT_RE = re.compile(r"([+-]?[0-9]+(?:_[0-9]+)*)\.0*")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_I64 = 1 << 63
ID_PATTERN = r"^[a-zA-Z0-9\-_ ]+$"


class ValidationError(ValueError):
    def __init__(self, title: str, errors: list[dict]):
        self.title = title
        self._errors = errors
        super().__init__(f"{len(errors)} validation error(s) for {title}: "
                         + "; ".join(f"{'.'.join(map(str, e['loc']))}: "
                                     f"{e['msg']}" for e in errors))

    def errors(self) -> list[dict]:
        return [dict(e) for e in self._errors]


class _Fail(Exception):
    def __init__(self, type_: str, msg: str, ctx: dict | None = None,
                 loc: tuple = ()):
        super().__init__(msg)
        self.err = {"type": type_, "loc": loc, "msg": msg}
        if ctx is not None:
            self.err["ctx"] = ctx


class _Nested(Exception):
    def __init__(self, errors: list[dict]):
        super().__init__()
        self.errors = errors


def _num(v) -> str:
    return format(v, "g") if isinstance(v, float) else str(v)


def _bounds(v, ge=None, le=None):
    """pydantic's order: le, then ge."""
    if le is not None and not v <= le:
        raise _Fail("less_than_equal",
                    f"Input should be less than or equal to {_num(le)}",
                    {"le": le})
    if ge is not None and not v >= ge:
        raise _Fail("greater_than_equal",
                    f"Input should be greater than or equal to {_num(ge)}",
                    {"ge": ge})
    return v


def v_int(v, ge=None, le=None) -> int:
    if isinstance(v, (bytes, bytearray)):
        try:
            v = bytes(v).decode()
        except UnicodeDecodeError:
            raise _Fail("int_parsing", "Input should be a valid integer, "
                        "unable to parse string as an integer") from None
    if isinstance(v, bool):
        out = int(v)
    elif isinstance(v, int):
        out = v
    elif isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            raise _Fail("finite_number", "Input should be a finite number")
        if not v.is_integer():
            raise _Fail("int_from_float", "Input should be a valid integer, "
                        "got a number with a fractional part")
        if abs(v) >= _I64:
            raise _Fail("int_parsing_size", "Unable to parse input string "
                        "as an integer, exceeded maximum size")
        out = int(v)
    elif isinstance(v, str):
        s = v.strip()
        m = _INT_RE.fullmatch(s) or _INT_DOT_RE.fullmatch(s)
        if m is None:
            raise _Fail("int_parsing", "Input should be a valid integer, "
                        "unable to parse string as an integer")
        out = int(m.group(1) if m.re is _INT_DOT_RE else s)
    else:
        raise _Fail("int_type", "Input should be a valid integer")
    return _bounds(out, ge, le)


def v_strict_float(v, ge=None, le=None) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _Fail("float_type", "Input should be a valid number")
    return _bounds(float(v), ge, le)


def v_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (bytes, bytearray)):
        try:
            v = bytes(v).decode()
        except UnicodeDecodeError:
            raise _Fail("bool_parsing", "Input should be a valid boolean, "
                        "unable to interpret input") from None
    if isinstance(v, str):
        s = v.lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise _Fail("bool_parsing", "Input should be a valid boolean, "
                    "unable to interpret input")
    if isinstance(v, (int, float)):
        if v == 0 or v == 1:
            return bool(v)
        if isinstance(v, int) or float(v).is_integer():
            raise _Fail("bool_parsing", "Input should be a valid boolean, "
                        "unable to interpret input")
    raise _Fail("bool_type", "Input should be a valid boolean")


def v_str(v, min_length=None, max_length=None, pattern=None) -> str:
    if isinstance(v, (bytes, bytearray)):
        try:
            v = bytes(v).decode()
        except UnicodeDecodeError:
            raise _Fail("string_unicode", "Input should be a valid string, "
                        "unable to parse raw data as a unicode string") \
                from None
    if not isinstance(v, str):
        raise _Fail("string_type", "Input should be a valid string")
    if min_length is not None and len(v) < min_length:
        raise _Fail("string_too_short", f"String should have at least "
                    f"{min_length} character{'s' * (min_length != 1)}",
                    {"min_length": min_length})
    if max_length is not None and len(v) > max_length:
        raise _Fail("string_too_long", f"String should have at most "
                    f"{max_length} character{'s' * (max_length != 1)}",
                    {"max_length": max_length})
    # the pattern as pydantic's regex engine reads it: '$' is the end of
    # the text, not also the place before a final newline
    if pattern is not None and re.fullmatch(pattern[1:-1], v) is None:
        raise _Fail("string_pattern_mismatch",
                    f"String should match pattern '{pattern}'",
                    {"pattern": pattern})
    return v


def v_bytes(v) -> bytes:
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    raise _Fail("bytes_type", "Input should be a valid bytes")


def v_literal(v, choices: tuple) -> str:
    if isinstance(v, str) and v in choices:
        return v
    quoted = [repr(c) for c in choices]
    expected = ", ".join(quoted[:-1]) + " or " + quoted[-1]
    raise _Fail("literal_error", f"Input should be {expected}",
                {"expected": expected})


def v_optional(fn):
    return lambda v: None if v is None else fn(v)


def v_list(item):
    """A list (or tuple) validated item by item: all items' errors, each
    under its index."""
    def check(v):
        if not isinstance(v, (list, tuple)):
            raise _Fail("list_type", "Input should be a valid list")
        out, errors = [], []
        for i, x in enumerate(v):
            try:
                out.append(item(x))
            except _Fail as e:
                errors.append({**e.err, "loc": (i, *e.err["loc"])})
            except _Nested as e:
                errors.extend({**err, "loc": (i, *err["loc"])}
                              for err in e.errors)
        if errors:
            raise _Nested(errors)
        return out
    return check


def v_model(cls):
    def check(v):
        try:
            return cls.from_dict(v)
        except ValidationError as e:
            raise _Nested(e.errors()) from None
    return check


def _spec(check, default=_MISSING):
    """A dataclass field with its validator (and its default, when it has
    one; a list default is copied per instance)."""
    meta = {"check": check}
    if default is _MISSING:
        return field(metadata=meta)
    if isinstance(default, list):
        return field(default_factory=list, metadata=meta)
    return field(default=default, metadata=meta)


class _Model:
    @classmethod
    def from_dict(cls, data):
        if not isinstance(data, dict):
            raise ValidationError(cls.__name__, [{
                "type": "model_type", "loc": (),
                "msg": f"Input should be a valid dictionary or instance of "
                       f"{cls.__name__}",
                "ctx": {"class_name": cls.__name__}}])
        values, errors = {}, []
        for f in fields(cls):
            if f.name not in data:
                if _no_default(f):
                    errors.append({"type": "missing", "loc": (f.name,),
                                   "msg": "Field required"})
                continue
            try:
                values[f.name] = f.metadata["check"](data[f.name])
            except _Fail as e:
                errors.append({**e.err, "loc": (f.name, *e.err["loc"])})
            except _Nested as e:
                errors.extend({**err, "loc": (f.name, *err["loc"])}
                              for err in e.errors)
        if errors:
            raise ValidationError(cls.__name__, errors)
        return cls(**values)


def _no_default(f) -> bool:
    return f.default is MISSING and f.default_factory is MISSING


def _id(v):
    return v_str(v, min_length=1, max_length=255, pattern=ID_PATTERN)


@dataclass
class ServeVQGANEncodeRequest(_Model):
    audios: list = _spec(v_list(v_bytes))


@dataclass
class ServeVQGANEncodeResponse:
    tokens: list


@dataclass
class ServeVQGANDecodeRequest(_Model):
    tokens: list = _spec(v_list(v_list(v_list(v_int))))


@dataclass
class ServeVQGANDecodeResponse:
    audios: list  # PCM float16 bytes


@dataclass
class ServeReferenceAudio(_Model):
    audio: bytes = _spec(v_bytes)
    text: str = _spec(v_str)

    @classmethod
    def from_dict(cls, data):
        # the reference's "before" validator: a long string is base64
        # audio; one that does not decode stays the string's bytes
        audio = data.get("audio")
        if isinstance(audio, str) and len(audio) > 255:
            try:
                data = {**data, "audio": base64.b64decode(audio)}
            except Exception:  # noqa: BLE001 - the validator's own rule
                pass
        return super().from_dict(data)

    def __repr__(self) -> str:
        return (f"ServeReferenceAudio(text={self.text!r}, "
                f"audio_size={len(self.audio)})")


@dataclass
class ServeTTSRequest(_Model):
    text: str = _spec(v_str)
    # the reference's conint() in Annotated metadata is ignored by pydantic
    # v2; the JAX package validates the documented 100..1000, as here
    chunk_length: int = _spec(lambda v: v_int(v, ge=100, le=1000), 200)
    format: str = _spec(lambda v: v_literal(v, ("wav", "pcm", "mp3",
                                                "opus")), "wav")
    latency: str = _spec(lambda v: v_literal(v, ("normal", "balanced")),
                         "normal")
    references: list = _spec(v_list(v_model(ServeReferenceAudio)), [])
    reference_id: str | None = _spec(v_optional(v_str), None)
    seed: int | None = _spec(v_optional(v_int), None)
    use_memory_cache: str = _spec(lambda v: v_literal(v, ("on", "off")),
                                  "off")
    normalize: bool = _spec(v_bool, True)
    streaming: bool = _spec(v_bool, False)
    max_new_tokens: int = _spec(v_int, 1024)
    top_p: float = _spec(lambda v: v_strict_float(v, ge=0.1, le=1.0), 0.8)
    repetition_penalty: float = _spec(
        lambda v: v_strict_float(v, ge=0.9, le=2.0), 1.1)
    temperature: float = _spec(
        lambda v: v_strict_float(v, ge=0.1, le=1.0), 0.8)


@dataclass
class UpdateReferenceRequest(_Model):
    old_reference_id: str = _spec(_id)
    new_reference_id: str = _spec(_id)


@dataclass
class AddReferenceRequest(_Model):
    id: str = _spec(_id)
    audio: bytes = _spec(v_bytes)
    text: str = _spec(lambda v: v_str(v, min_length=1))


@dataclass
class AddReferenceResponse:
    success: bool
    message: str
    reference_id: str


@dataclass
class ListReferencesResponse:
    success: bool
    reference_ids: list
    message: str = "Success"


@dataclass
class DeleteReferenceResponse:
    success: bool
    message: str
    reference_id: str

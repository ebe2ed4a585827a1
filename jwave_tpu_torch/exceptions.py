"""Exception hierarchy, the same classes as ``jwave_tpu.exceptions``.

``JWaveException`` is the base; ``JWaveFailure`` covers bad input (wrong
length, unknown name, ...) and its subclasses name the kind. The API raises;
it never catches and prints.
"""


class JWaveException(Exception):
    """Base of all jwave_tpu_torch errors."""


class JWaveError(JWaveException):
    """Non-recoverable internal error."""


class JWaveFailure(JWaveException):
    """Recoverable failure caused by bad input (wrong length, unknown name, ...)."""


class JWaveNotAllocated(JWaveFailure):
    pass


class JWaveNotFound(JWaveFailure):
    pass


class JWaveNotImplemented(JWaveFailure):
    pass


class JWaveNotKnown(JWaveFailure):
    pass


class JWaveNotValid(JWaveFailure):
    pass

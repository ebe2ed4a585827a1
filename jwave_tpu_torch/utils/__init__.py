from .numerics import (
    ancient_egyptian_compose,
    ancient_egyptian_decompose,
    ancient_egyptian_decompose_blocked,
    create_cosine_oscillation,
    create_sine_oscillation,
    exponent_of_two,
    is_power_of_two,
    next_power_of_two,
    scalb,
)

__all__ = [
    "is_power_of_two", "next_power_of_two", "exponent_of_two", "scalb",
    "ancient_egyptian_decompose", "ancient_egyptian_decompose_blocked",
    "ancient_egyptian_compose", "create_sine_oscillation", "create_cosine_oscillation",
]

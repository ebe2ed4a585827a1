from .numerics import exponent_of_two, is_power_of_two

__all__ = ["exponent_of_two", "is_power_of_two"]

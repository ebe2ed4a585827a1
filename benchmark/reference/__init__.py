"""The plain reference of the benchmark: float64 torch by the published
definitions, with a frozen copy of the filters. It imports nothing of the
program under test and takes nothing that the program made."""

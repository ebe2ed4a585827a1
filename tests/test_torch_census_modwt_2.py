"""The parity census: the cases of tests/torch_census_cases.py with
``file="modwt_2"`` (what each is held to: ``torch_census_cases.make_test``)."""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

import torch_census_cases as census  # noqa: E402

test_census = census.make_test("modwt_2", jt, jw, jax.jit)

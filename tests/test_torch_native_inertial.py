"""The port's native tracker on an RGB-D + IMU sequence: the analogue of
tests/test_native.py::test_accel_bias_recovery_known_gravity (that test's
body with the port's NativeTracker).
"""

import pytest

import test_native
from test_torch_native import (  # noqa: F401 (fixtures)
    port_tracker,
    serial_opencv,
)
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.usefixtures("port_tracker", "serial_opencv")


def test_accel_bias_recovery_known_gravity():
    test_native.test_accel_bias_recovery_known_gravity()

"""xArm6 robot wrapper, hardware-gated (a copy of
``adaptigraph_tpu/realworld/xarm.py``).

Mirrors the reference's ``XARM6`` contract (reference:
``src/planning/real_world/xarm6.py:9-170``): position/servo motion modes,
gripper open/close, error/warn callbacks that clear faults and re-enable the
arm. The SDK (``xarm``) is not present in this environment; construction
raises with guidance, and the class documents the planner-facing surface so
hardware bring-up is a drop-in.
"""

import numpy as np

XARM_DEFAULT_IP = "192.168.1.209"


class XARM6:
    """Planner-facing surface (matching the reference wrapper):

    - ``get_position()`` -> (6,) [x, y, z, roll, pitch, yaw] mm/deg
    - ``move_to_position(pose, wait=True)`` Cartesian move
    - ``get_servo_angle()`` / ``set_servo_angle(angles)`` joint-space
    - ``open_gripper()`` / ``close_gripper()``
    - error callback: clean errors, re-enable motion, restore state
      (reference: xarm6.py:107-126)
    """

    def __init__(self, ip=XARM_DEFAULT_IP, speed=100):
        try:
            from xarm.wrapper import XArmAPI  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "the xArm SDK is not installed; the closed loop runs "
                "hardware-free via realworld.env.SimRealEnv") from e
        self.speed = speed
        self.arm = XArmAPI(ip)
        self.arm.motion_enable(enable=True)
        self.arm.set_mode(0)
        self.arm.set_state(state=0)
        self.arm.register_error_warn_changed_callback(self._on_error)

    def _on_error(self, data):
        if data and data.get("error_code", 0) != 0:
            self.arm.clean_error()
            self.arm.motion_enable(enable=True)
            self.arm.set_mode(0)
            self.arm.set_state(state=0)

    def get_position(self):
        code, pos = self.arm.get_position()
        assert code == 0, f"xarm get_position error {code}"
        return np.asarray(pos, np.float64)

    def move_to_position(self, pose, wait=True):
        code = self.arm.set_position(*pose, speed=self.speed, wait=wait)
        assert code == 0, f"xarm set_position error {code}"

    def get_servo_angle(self):
        code, angles = self.arm.get_servo_angle()
        assert code == 0
        return np.asarray(angles, np.float64)

    def set_servo_angle(self, angles, wait=True):
        code = self.arm.set_servo_angle(angle=list(angles), speed=self.speed,
                                        wait=wait)
        assert code == 0

    def open_gripper(self):
        self.arm.set_gripper_position(850, wait=True)

    def close_gripper(self):
        self.arm.set_gripper_position(0, wait=True)

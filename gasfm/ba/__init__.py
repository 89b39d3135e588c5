"""Bundle adjustment (native C++): Euclidean and projective drivers.

Parity surface: reference L11 — code/utils/ba_functions.py (drivers),
code/utils/ceres_utils.py (parameter packing), and
bundle_adjustment/custom_cpp_cost_functions.cpp (cost functions). The
solver here is a self-contained C++ Levenberg-Marquardt bundle adjuster
with analytic Jacobians, Huber loss and a dense Schur complement (no
Ceres/Eigen dependency), driven through ctypes.
"""

from gasfm.ba.drivers import euc_ba, proj_ba
from gasfm.ba.packing import order_cam_param_for_c, reorder_from_c_to_py

__all__ = ["euc_ba", "proj_ba", "order_cam_param_for_c", "reorder_from_c_to_py"]

"""How the ``test_torch_*`` step tests hold the parameters after an Adam
step to a reference's.

Adam divides each entry of its first moment by the root of its second, so an
update has about the size of the learning rate whatever the gradient's size.
Where a gradient entry lies within the rounding of zero, two correct runs
can compute it with opposite signs, and Adam turns that into steps of
opposite sign: the parameters then differ by up to twice the rate. Which
entries those are depends on how the host's CPU kernels round, so naming
them (a layer, a bias) is not enough. The check is made per entry instead:

* the first moment (at the first step, the gradient itself) is held to its
  own bound, ``moment_tol``;
* an entry whose reference moment stands clear of that bound has the same
  sign on both sides, and its parameter is held to the tight bound,
  ``param_tol``;
* an entry whose reference moment lies within the bound may have flipped:
  its parameter is allowed ``step_allowance`` (twice the step) beside it.
"""

from __future__ import annotations

import numpy as np


def assert_adam_step_matches(got: dict, want: dict, moment_got: dict, moment_want: dict, moment_tol: dict,
                             param_tol: dict, step_allowance: float) -> None:
    """Every entry of ``got`` against ``want`` (name -> array), after a step
    whose first moments were ``moment_got`` and ``moment_want`` (same names).
    ``moment_tol`` and ``param_tol``: dicts of ``atol`` and ``rtol``."""
    assert set(got) == set(want) and set(moment_want) == set(want), sorted(set(got) ^ set(want) ^ set(moment_want))
    for name, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[name], np.float64)
        m_w, m_g = np.asarray(moment_want[name], np.float64), np.asarray(moment_got[name], np.float64)
        bound = moment_tol["atol"] + moment_tol["rtol"] * np.abs(m_w)
        far = np.abs(m_g - m_w) > bound
        assert not far.any(), (f"{name}: {far.sum()} of {far.size} first-moment entries beyond their bound, at most "
                               f"{np.abs(m_g - m_w).max():.3g} (bound there {bound.ravel()[np.argmax(far)]:.3g})")
        clear = np.abs(m_w) > bound
        tol = param_tol["atol"] + param_tol["rtol"] * np.abs(w) + np.where(clear, 0.0, step_allowance)
        bad = np.abs(g - w) > tol
        if bad.any():
            i = np.flatnonzero(bad.ravel())[0]
            raise AssertionError(f"{name}: {bad.sum()} of {bad.size} entries beyond their bound; the first at flat index "
                                 f"{i}: got {g.ravel()[i]:.8g}, want {w.ravel()[i]:.8g}, bound {tol.ravel()[i]:.3g} "
                                 f"(reference moment {m_w.ravel()[i]:.3g}, {'clear of' if clear.ravel()[i] else 'within'} "
                                 f"its bound {bound.ravel()[i]:.3g})")

"""The train/validation split of the ISPRS CLI without scikit-learn.

The JAX CLI calls `sklearn.model_selection.train_test_split(idx,
test_size=0.2, random_state=42)` (resuneta_tpu/cli/train_isprs.py:100,
:110). For an integer seed and a float test size that is a ShuffleSplit:
one `np.random.RandomState(seed).permutation(n)`, the first
ceil(test_size * n) positions for the test set, the next
n - ceil(test_size * n) for the train set. `train_test_split` here
reproduces it, held to scikit-learn 1.9.0 in the tests.
"""

import math

import numpy as np


def train_test_split(idx, test_size=0.2, random_state=42):
    """(train, test) of the array `idx`, as scikit-learn returns them for a
    float `test_size` in (0, 1) and an integer `random_state`. Raises
    ValueError where scikit-learn does: a train or test set that would be
    empty."""
    idx = np.asarray(idx)
    n = len(idx)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0 or n_test == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, "
            "the resulting train set will be empty. Adjust any of the "
            "aforementioned parameters.")
    perm = np.random.RandomState(random_state).permutation(n)
    return idx[perm[n_test:n_test + n_train]], idx[perm[:n_test]]

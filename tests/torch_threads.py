"""A fixture for the port's host-loop parity tests: torch and the BLAS
libraries (numpy's and scipy's OpenBLAS, which the JAX package's CPU
LAPACK calls) compute on one thread within their module. Each of their
tests solves small problems in both packages, whose linear algebra spends
more time waking threads than computing when pytest-xdist runs several
workers on the machine's cores. Import it into a test module to apply it
there."""
import pytest
import scipy.linalg  # noqa: F401 (loads scipy's OpenBLAS, for threadpoolctl to limit)
import threadpoolctl
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)

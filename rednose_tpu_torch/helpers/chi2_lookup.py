"""Mirror of `rednose.helpers.chi2_lookup` (see helpers/__init__.py): the
same surface, computed by utils/chi2.py instead of read from a shipped
.npy table."""

from rednose_tpu_torch.utils.chi2 import chi2_ppf, gen_chi2_ppf_lookup  # noqa: F401

from rednose_tpu_torch.frontend.sympy_spec import spec_from_sympy  # noqa: F401

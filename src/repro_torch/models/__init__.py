"""Model zoo (port of `repro/models/`): the dense and SSM families' forward,
training and serving paths.

`config` and `spec` describe a model; `layers`, `transformer` and `ssm`
apply it functionally over a nested dict of tensors, in the reference's
layouts;
`model.Model` owns the parameters as an `nn.Module` whose names mirror the
reference's tree; `convert.params_from_jax` moves the reference's values
across.
"""

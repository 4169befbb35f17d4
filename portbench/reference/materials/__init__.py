"""BSDFs of the reference, one module per Mitsuba bsdf type.

Each module defines `parse(node, parser) -> {param: value}` and, on
batches of lanes of its type, `sample(p, n, geo_n, dir_in, draw) ->
(dir_out, pdf)`, `eval(p, n, geo_n, dir_in, dir_out) -> BSDF x cosine`
and `pdf(p, n, geo_n, dir_in, dir_out)`: `p` the lanes' parameters by
name, `n` the shading normal turned toward `dir_in`, `geo_n` the
geometric normal facing the arriving ray, `draw(dim)` the lane's draw of
this bounce's dimension `dim` (rng module's names). A zero pdf marks a
failed sample. Optional, where the defaults do not hold:
`eval_sampled(p, n, geo_n, dir_in, dir_out, pdf)` for the sampled
direction (default `eval`); `specular(p) -> [N] bool`, lanes whose
sample is a delta lobe, which take no light sample and weigh what their
sample finds by 1 / pdf (default none); `nee_skip(p, geo_n, dir_in,
light_dir) -> [N] bool`, lanes to which a light sample gives nothing for
any parameter value (default: either direction below the geometric
surface).
"""

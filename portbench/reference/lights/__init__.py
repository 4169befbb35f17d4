"""Emitters of the reference, one module per Mitsuba emitter type.

The tracer chooses one light slot per vertex, uniformly, and asks the
slot's module. An emitter held by a shape (an area light) defines
`parse(node, parser) -> radiance [3]`; a light of the scene itself
defines `attach(node, parser) -> payload`, optionally `to_device(payloads,
device, dtype) -> data` (the scene's `light_data[type]`), and
`LAST = True` if its slots come after all others. Then, on batches of
lanes whose slot is of its type (`emit`: each slot's radiance of a light
on a shape, scaled as the tracer is asked; `draw(dim)`: the lane's draw
of this bounce's dimension `dim`, `rng` module's names):

  sample(scene, slot, pos, draw, n_slots, emit) -> dict
      dir, dist (inf for a light at infinity), radiance, pdf (per solid
      angle, with the choice's 1 / n_slots), valid; a module with
      `DELTA = True` is a light no BSDF sample reaches, weighted 1 / pdf.
  hit_pdf(scene, hit, em, ref_pos, dir, n_slots) -> pdf, for lights on
      surfaces, where a BSDF sample from `ref_pos` along `dir` hits them
      (`em`: the lanes that hit an emitter).
  escape(scene, dirs, n_slots) -> (radiance, pdf), for lights at infinity,
      which an escaping ray sees; the flat background is seen only where
      the scene has none.
"""

"""Application harness and CLI tools (reference: ohmapp/ + utils/).

CLI entry points (python -m ohm_tpu_torch.app.<tool>):
  ohmpop        populate a map from a cloud (+trajectory)  [utils/ohmpop]
  ohminfo       dump .ohm header/layout/info               [utils/ohminfo]
  ohm2ply       export .ohm to PLY                         [utils/ohm2ply]
  ohmheightmap  heightmap generation                       [utils/ohmheightmap]
  ohmhm2img     heightmap -> image                         [utils/ohmhm2img]
  ohmfilter     filter a cloud against a map               [utils/ohmfilter]
  ohmquery      run queries                                [utils/ohmquery]
  ohmprob       probability <-> value                      [utils/ohmprob]
  ohmcmp        compare two maps                           [utils/ohmcmp]
  ohmsubmap     extract a sub-map                          [utils/ohmsubmap]
"""

"""What a configuration's ``mode`` (ohmpop's ``--mode``) brings to a run:
``ohmbench/modes/<mode>.py``, found by name (``ohmbench.find``).  A mode
module gives

``NUMBERS``
    the names of the numbers that decide ``correct`` in its cells, each
    with a limit in ``ohmbench/limits/<cell>.json``;
``make_reference(config, geometry=None, values=None)``
    the plain reference (``ohmbench/reference``), in the precisions given
    or, by default, those the configuration's ``precision`` states;
``program_map(m, config, device)``
    the program's map, read back into the host map ``m``, in the
    reference's form (``reference.compare.read_map``);
``compare(prog, ref, resolution)``
    ``{number: result}`` for the numbers of ``NUMBERS`` that come from
    comparing the program's map with the reference's, each result a dict
    with ``voxels`` and ``mismatched`` (``reference.compare.share``); the
    mode draws on ``reference.compare``'s ``mismatch`` and
    ``ndt_mismatch`` or brings its own;
``VALUE_LAYERS``
    the arena layers whose values ``compare`` reads: the tests' planted
    fault alters what each batch wrote to them;
``counted(stats)``
    the numbers of ``NUMBERS`` that the program's own stats give (after
    ``sync_voxels``), beside those the comparison and the run give.
"""

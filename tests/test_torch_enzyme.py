"""The port's enzyme table (hichap_master_tpu_torch.pipeline.enzyme, a copy
of hichap_master_tpu/pipeline/enzyme.py) against the JAX package's: every
built-in enzyme resolves to the same site and cut and gives the same
junctions, and the custom ``A-AGCTT`` syntax and its refusals agree.
Strings and integers only, so equality is exact."""

import pytest

from hichap_master_tpu.pipeline import enzyme as J
from hichap_master_tpu_torch.pipeline import enzyme as P


def test_the_tables_are_the_same():
    assert P.ENZYME_DB == J.ENZYME_DB
    assert len(P.ENZYME_DB) == 80


@pytest.mark.parametrize("name", sorted(J.ENZYME_DB))
def test_every_enzyme_resolves_as_in_the_jax_package(name):
    got = P.enzyme_handle(name)
    assert got == J.enzyme_handle(name)
    assert P.junction_info(*got) == J.junction_info(*got)


@pytest.mark.parametrize("spec", ["A-AGCTT", "G-AATTC", "GATC-", "-GATC",
                                  "AC-GTT", "-"])
def test_custom_specs_resolve_as_in_the_jax_package(spec):
    got = P.enzyme_handle(spec)
    assert got == J.enzyme_handle(spec)
    assert P.junction_info(*got) == J.junction_info(*got)


@pytest.mark.parametrize("spec", ["A-AG-CTT", "A-AGNTT", "NoSuchEnzyme", ""])
def test_bad_specs_are_refused_as_in_the_jax_package(spec):
    with pytest.raises(ValueError) as jerr:
        J.enzyme_handle(spec)
    with pytest.raises(ValueError) as perr:
        P.enzyme_handle(spec)
    assert str(perr.value) == str(jerr.value)

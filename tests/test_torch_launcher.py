"""The kernel layer's one launcher (`ops/cuda/build.py::KERNELS`) against
the CUDA sources, without a card: every launch entry of `csrc/*.cu` (an
`extern "C"` function other than `*_error_string` and the host query
`bin_sort_temp_bytes`) has exactly one handle, in its own library, whose
argument layout is the entry's C signature, so no kernel is reached around
the launcher."""

import re

from gaussian_splatting_web_tpu_torch.ops.cuda import build

NOT_LAUNCHES = ("bin_sort_temp_bytes",)
FUNCTION = re.compile(r"^(?:extern \"C\"\s+)?(?:int|const char\s*\*)\s+(\w+)"
                      r"\s*\(([^)]*)\)\s*\{", re.M)


def _c_entries():
    """{entry: (library, argument kinds)} of every extern "C" function in
    csrc/*.cu, kinds one letter an argument: p pointer, i int or bool, f
    float."""
    entries = {}
    for src in sorted(build.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text,
                            re.S)
        blocks += re.findall(r'^extern "C"\s+[^{]*\{', text, re.M)
        for block in blocks:
            for name, params in FUNCTION.findall(block):
                kinds = "".join(
                    "p" if "*" in p else "f" if p.split()[0] == "float"
                    else "i" for p in (q.strip() for q in params.split(","))
                    if p)
                assert name not in entries, f"{name} defined twice"
                entries[name] = (src.stem, kinds)
    return entries


def test_every_launch_entry_has_one_handle():
    entries = {name: v for name, v in _c_entries().items()
               if not name.endswith("_error_string")
               and name not in NOT_LAUNCHES}
    assert len(entries) >= 10 and "raster_fwd_tiles" in entries
    assert sorted(build.KERNELS) == sorted(entries)
    for entry, kernel in build.KERNELS.items():
        lib, kinds = entries[entry]
        assert (kernel.entry, kernel.lib) == (entry, lib)
        # every launch ends in (int device, void* stream)
        assert kinds.endswith("ip"), (entry, kinds)
        assert kernel.kinds() == kinds[:-2], (entry, kernel.layout, kinds)
    names = [k.name for k in build.KERNELS.values() if k.name]
    assert sorted(names) == sorted(build.launch_counts())
    assert len(set(names)) == len(names)
    assert set(names) == {"A", "B", "C", "D", "E-A", "E-B", "P", "P-bwd",
                          "bin", "adam"}

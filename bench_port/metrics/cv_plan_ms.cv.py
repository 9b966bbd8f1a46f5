"""Host time a CV call in checking its Grams and planning its fits, in
ms: the self time of the program's ``grakel_torch.cv.check`` spans (the
non-finite scan and the stack before the upload) and
``grakel_torch.cv.plan`` spans (each stage's fit lists, its pick of the
inner fits' best, and its K15 / K16 plan), summed over the window and
divided by the calls."""

from bench_port.spans import self_ms


def read(run):
    return self_ms(run, ("cv.check", "cv.plan"))

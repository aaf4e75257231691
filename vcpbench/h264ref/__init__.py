"""The benchmark's plain H.264 reference decoder (Python and NumPy).

A frozen copy of the port's library-free decode path, which imports
nothing of ``vcp_tpu_torch``: ``decoder.H264Decoder`` parses CABAC in
Python and reconstructs and deblocks in NumPy. The port's decoder is
checked against libx264's streams (``tests/golden``); this copy only
reads the port's encoder output, so a later change to the port cannot
move the yardstick that judges it.
"""

"""The serving kernels as ``torch.library`` custom ops in the ``mmbidaf``
namespace, registered by importing their wrapper modules:

    torch.ops.mmbidaf.bilstm            K1  (ops/cuda/lstm_kernel.py)
    torch.ops.mmbidaf.bidaf             K2, and K9 past K2's plan (ops/cuda/bidaf_kernel.py)
    torch.ops.mmbidaf.mfcc              K3  (ops/cuda/melspec_kernel.py)
    torch.ops.mmbidaf.log_mel           K4  (ops/cuda/melspec_kernel.py)
    torch.ops.mmbidaf.winograd_conv3x3  K14 (ops/cuda/winograd_kernel.py)
    torch.ops.mmbidaf.conv_epilogue     the VGG convs' bias, ReLU and pool
                                        (ops/cuda/conv_epilogue_kernel.py)

Each op's CPU implementation is its kernel's plain version, its CUDA
implementation the launch (the only place the wrapper's counters move), and
its fake implementation allocates the outputs, so ``torch.export`` records
one node a call. A program exported through them loads in a process that
imports this module: ``export.ExportedDecoder`` does, and nothing of the
model's code.
"""

from mmbidaf_tpu_torch.ops.cuda import (bidaf_kernel, conv_epilogue_kernel, lstm_kernel,
                                        melspec_kernel, winograd_kernel)

OPS = {
    "K1": lstm_kernel.bilstm_op,
    "K2": bidaf_kernel.bidaf_op,
    "K3": melspec_kernel.mfcc_op,
    "K4": melspec_kernel.log_mel_op,
    "K14": winograd_kernel.winograd_op,
    "conv_epilogue": conv_epilogue_kernel.conv_epilogue_op,
}

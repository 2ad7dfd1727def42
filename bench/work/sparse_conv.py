"""One ``sparse_conv`` call: an implicit-GEMM block-sparse conv of NHWC
bf16 x over the stored (ob, n_k, bm, bn) blocks, with bias, an optional
residual and the bf16 output."""


def work(call: dict) -> tuple[int, int, str]:
    n, c, k, s = call["n"], call["c"], call["k"], call["stride"]
    ho, wo = -(-call["h"] // s), -(-call["w"] // s)
    ob, n_k, bm, bn = call["ob"], call["n_k"], call["bm"], call["bn"]
    cout = ob * bn
    m = n * ho * wo
    ops = 2 * m * ob * n_k * bm * bn
    nbytes = (2 * n * call["h"] * call["w"] * c          # x
              + call["w_bytes"] * ob * n_k * bm * bn      # stored blocks
              + 4 * ob * n_k                              # block ids
              + 2 * cout                                  # bias
              + 2 * m * cout * (2 if call["residual"] else 1))
    return ops, nbytes, "bfloat16"

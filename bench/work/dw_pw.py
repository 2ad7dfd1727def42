"""One ``dw_pw`` call: a k x k depthwise conv (bias, ReLU) feeding a
dense 1x1 conv (bias, optional residual) in one kernel, NHWC bf16, the
depthwise output never written. All operations are held to the bf16
tensor-core rate: a lower bound, since the depthwise runs on CUDA
cores."""


def work(call: dict) -> tuple[int, int, str]:
    n, c, co, k, s = call["n"], call["c"], call["cout"], call["k"], \
        call["stride"]
    m = n * -(-call["h"] // s) * -(-call["w"] // s)
    ops = 2 * m * c * (k * k + co)
    nbytes = (2 * n * call["h"] * call["w"] * c          # x
              + 2 * (k * k * c + c)                       # depthwise w, b
              + call["w_bytes"] * c * co + 2 * co         # pointwise w, b
              + 2 * m * co * (2 if call["residual"] else 1))
    return ops, nbytes, "bfloat16"

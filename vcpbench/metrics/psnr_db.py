"""psnr_db: mean luma PSNR of the frames the comparison decodes with the
benchmark's reference decoder, against the seed's source frames."""


def read(obs):
    return obs["check"]["psnr_db"]

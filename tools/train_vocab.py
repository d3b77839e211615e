"""Offline vocabulary trainer (the analogue of building DBoW2's shipped
ORBvoc.txt — reference include/ORBVocabulary.h:25-31, loaded at startup in
src/System.cc:65-78).

Renders a diverse set of synthetic scenes (different room seeds, layouts
and trajectories), extracts ORB descriptors from every frame, and trains
the two-level codebook on the pooled sample. The result ships as a small
npz that `System` loads at startup, so live sessions pay ZERO mid-run
retrain stalls and loop detection is strong from the first keyframe (the
session-trained reservoir path remains as a fallback when no file is
available, e.g. custom camera domains).

Usage:
    python tools/train_vocab.py [--out orbslam2_tpu/data/vocab.npz]
        [--words 16384] [--frames-per-scene 32] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="orbslam2_tpu/data/vocab.npz")
    ap.add_argument("--words", type=int, default=16384)
    ap.add_argument("--frames-per-scene", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--idf-only", action="store_true",
                    help="keep the existing codebook in --out; only "
                         "(re)compute the per-word idf weights over the "
                         "scene grid (each FRAME is a document, like "
                         "DBoW2's per-image training corpus)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from orbslam2_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np

    from orbslam2_tpu.config import CameraConfig, OrbConfig
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.ops import orb
    from orbslam2_tpu.vocab import bow

    # scene/trajectory grid: room seeds x kinds x 2 camera scales.
    # Diversity in layout, texture seed, viewpoint and scale matters more
    # than frame count per scene (descriptors within a scene correlate).
    cams = [
        CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0),
        CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0,
                     width=320, height=240),
    ]
    kinds = ["forward", "lateral", "orbit", "outback"]
    seeds = [0, 1, 2, 3, 4, 5]

    pool = []          # per-frame descriptor batches (frame = document)
    ocfg = OrbConfig(num_features=1000, feature_slots=1024)
    extract = orb.extract
    for cam in cams:
        for kind in kinds:
            for seed in seeds:
                seq = synthetic.textured_sequence(
                    n_frames=args.frames_per_scene, kind=kind, seed=seed,
                    cam=cam,
                )
                for i in range(args.frames_per_scene):
                    img, _ = seq.frame(i)
                    f = extract(jnp.asarray(img), ocfg)
                    v = np.asarray(f.valid)
                    pool.append(np.asarray(f.desc)[v])
                print(f"# cam{cam.width}x{cam.height} {kind} seed{seed}: "
                      f"{sum(len(p) for p in pool)} descs", flush=True)

    def compute_idf(cb):
        # DBoW2 setNodeWeights: idf_w = log(N_docs / N_docs_containing_w)
        # over the training images (TemplatedVocabulary.h); unseen words
        # get the maximum weight
        V = bow.num_words(cb)
        n_docs = len(pool)
        df = np.zeros(V, np.int64)
        for batch in pool:
            if not len(batch):
                continue
            w = np.asarray(bow.word_ids(jnp.asarray(batch), cb))
            df[np.unique(w)] += 1
        idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
        print(f"# idf over {n_docs} docs: {int((df > 0).sum())}/{V} words "
              f"seen, idf range [{idf.min():.2f}, {idf.max():.2f}]")
        return idf

    if args.idf_only:
        z = np.load(args.out)
        if "coarse" in z.files:
            cb = bow.Codebook(coarse=jnp.asarray(z["coarse"]),
                              fine=jnp.asarray(z["fine"]))
        else:
            cb = jnp.asarray(z["codebook"])
        payload = {k: z[k] for k in z.files if k != "idf"}
        payload["idf"] = compute_idf(cb)
        np.savez_compressed(args.out, **payload)
        print(f"# wrote idf into {args.out} ({os.path.getsize(args.out)} bytes)")
        return

    descs = np.concatenate(pool)
    rng = np.random.default_rng(0)
    rng.shuffle(descs)
    n = len(descs)
    print(f"# pooled {n} descriptors")

    words = args.words
    if words > 4096:
        fine = words // 256
        cb = bow.train_codebook2(
            jnp.asarray(descs), jnp.ones(n, bool), jax.random.PRNGKey(0),
            coarse_size=256, fine_size=fine, iters=args.iters,
            bucket_cap=max(4096, 2 * n // 256),
        )
        payload = {"coarse": np.asarray(cb.coarse), "fine": np.asarray(cb.fine)}
    else:
        cb = bow.train_codebook(
            jnp.asarray(descs), jnp.ones(n, bool), jax.random.PRNGKey(0),
            vocab_size=words, iters=args.iters,
        )
        payload = {"codebook": np.asarray(cb)}

    payload["idf"] = compute_idf(cb)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **payload)
    print(f"# wrote {args.out} ({words} effective words, "
          f"{os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()

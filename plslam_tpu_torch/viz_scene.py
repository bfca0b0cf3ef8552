"""Interactive 3D scene export (``plslam_tpu.viz_scene``; the reference's
slamScene / sceneRepresentation, src/slamScene.cpp:1062 and
src2/sceneRepresentation.cpp:1066).

The reference renders a live OpenGL window with the trajectory, keyframes,
point and line landmarks and the covisibility graph.  The equivalent here
is a self-contained interactive HTML file: the map state is embedded as
JSON and drawn by a small WebGL viewer (orbit, pan, zoom, layer toggles,
keyframe frusta) with no external resources; open it in any browser.

It reads the host-side map store (``backend/mapping.SlamMap``: ``pt_w``,
``pt_valid``, ``ls_epw``, ``ls_nobs``, ``covis``, ``keyframes``), so it
works on a live pipeline, a finished run or a restored checkpoint.  The
page and its data are those of the JAX package's export.
"""

from __future__ import annotations

import json

import numpy as np


def _scene_data(mapper, gt=None, max_points: int = 20000) -> dict:
    """Collect the renderable map state into plain JSON-able lists."""
    m = mapper.map
    pts = (np.asarray(m.pt_w)[np.asarray(m.pt_valid)]
           if len(m.pt_valid) else np.zeros((0, 3)))
    if len(pts) > max_points:
        pts = pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]

    # line landmarks: the map maintains world endpoints (ls_epw, snapped
    # onto the BA-optimized line by the write-back) — one vectorized
    # gather instead of lifting each last observation in Python
    lsel = np.asarray(m.ls_valid) & (np.asarray(m.ls_nobs) > 0)
    segs = np.asarray(m.ls_epw)[lsel].round(4).tolist()

    kf_T = [k.T_w_k[:3].tolist() for k in m.keyframes if k.active]
    kf_ids = [k.id for k in m.keyframes if k.active]

    G = np.asarray(m.covis)
    th = getattr(mapper.cfg, "min_lm_cov_graph", 75)
    cov_edges = []
    kf_pos = {k.id: k.T_w_k[:3, 3] for k in m.keyframes if k.active}
    ii, jj = np.nonzero(np.triu(G, 1) >= th)
    for i, j in zip(ii.tolist(), jj.tolist()):
        if i in kf_pos and j in kf_pos:
            cov_edges.append([kf_pos[i].tolist(), kf_pos[j].tolist()])

    data = {
        "points": np.asarray(pts, np.float32).round(4).tolist(),
        "lines": segs,
        "kf_T": kf_T,
        "kf_ids": kf_ids,
        "cov_edges": cov_edges,
        "cov_threshold": int(th),
    }
    if gt is not None:
        g = np.asarray(gt, np.float32)
        # accept either (N, 3+) positions or (N, 4, 4) pose stacks (what
        # viz.render_run's callers pass; plot_trajectory does the same)
        pos = g[:, :3, 3] if g.ndim == 3 else g[:, :3]
        data["gt"] = pos.round(4).tolist()
    return data


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>plslam_tpu scene</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;
   font:12px system-ui,sans-serif;overflow:hidden}
 #hud{position:absolute;top:8px;left:8px;background:#0008;padding:8px 10px;
   border-radius:6px;line-height:1.7;user-select:none}
 #hud label{margin-right:10px;cursor:pointer}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>plslam_tpu scene</b> &mdash; drag: orbit &middot; shift-drag: pan &middot;
 wheel: zoom<br>
 <label><input type="checkbox" id="tp" checked> points</label>
 <label><input type="checkbox" id="tl" checked> lines</label>
 <label><input type="checkbox" id="tk" checked> keyframes</label>
 <label><input type="checkbox" id="tc" checked> covis graph</label>
 <label><input type="checkbox" id="tg" checked> ground truth</label>
 <label><input type="checkbox" id="tf"> follow camera</label>
 <label><input type="checkbox" id="ta"> auto-refresh</label>
 <span id="stats"></span>
</div>
<script>
const DATA = /*DATA*/;
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
const VS = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
 uniform float ps; varying vec3 vc;
 void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = ps; vc = col; }`;
const FS = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc,1.0); }`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o;}
const pr = gl.createProgram();
gl.attachShader(pr, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(pr, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(pr); gl.useProgram(pr);
const aP = gl.getAttribLocation(pr,'p'), aC = gl.getAttribLocation(pr,'col');
const uM = gl.getUniformLocation(pr,'mvp'),
      uS = gl.getUniformLocation(pr,'ps');

function buf(arr){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(arr),gl.STATIC_DRAW);
 return {b:b,n:arr.length/6};}

function flat(vs,c){const o=[];for(const v of vs)o.push(v[0],v[1],v[2],
 c[0],c[1],c[2]);return o;}
function segsFlat(ss,c){const o=[];for(const s of ss){o.push(
 s[0][0],s[0][1],s[0][2],c[0],c[1],c[2],
 s[1][0],s[1][1],s[1][2],c[0],c[1],c[2]);}return o;}

// keyframe frusta + trajectory polyline from 3x4 poses
function kfGeom(Ts){
 const lines=[], traj=[];
 const s=0.12, z=0.18;
 const cam=[[0,0,0],[-s,-s*0.7,z],[s,-s*0.7,z],[s,s*0.7,z],[-s,s*0.7,z]];
 for(const T of Ts){
  const R=[[T[0][0],T[0][1],T[0][2]],[T[1][0],T[1][1],T[1][2]],
           [T[2][0],T[2][1],T[2][2]]];
  const t=[T[0][3],T[1][3],T[2][3]]; traj.push(t);
  const w=cam.map(p=>[
   R[0][0]*p[0]+R[0][1]*p[1]+R[0][2]*p[2]+t[0],
   R[1][0]*p[0]+R[1][1]*p[1]+R[1][2]*p[2]+t[1],
   R[2][0]*p[0]+R[2][1]*p[1]+R[2][2]*p[2]+t[2]]);
  const e=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
  for(const [a,b] of e) lines.push([w[a],w[b]]);
 }
 const tl=[];
 for(let i=0;i+1<traj.length;i++) tl.push([traj[i],traj[i+1]]);
 return {fr:lines, traj:tl};
}
const KG = kfGeom(DATA.kf_T);
const bPts = buf(flat(DATA.points,[0.35,0.62,1.0]));
const bLns = buf(segsFlat(DATA.lines,[1.0,0.35,0.30]));
const bFr  = buf(segsFlat(KG.fr,[0.2,0.9,0.5]));
const bTr  = buf(segsFlat(KG.traj,[0.95,0.95,0.95]));
const bCv  = buf(segsFlat(DATA.cov_edges,[0.95,0.8,0.2]));
const bGt  = buf(DATA.gt ? segsFlat(
 DATA.gt.slice(1).map((p,i)=>[DATA.gt[i],p]),[0.55,0.4,0.9]) : []);
document.getElementById('stats').textContent =
 ` | ${DATA.points.length} pts, ${DATA.lines.length} lines, ` +
 `${DATA.kf_T.length} KFs, ${DATA.cov_edges.length} covis edges ` +
 `(>=${DATA.cov_threshold})`;

// center/scale: map centroid, or the NEWEST keyframe in follow mode
// (slamScene camera-follow analog) — live per-KF re-exports + the
// auto-refresh reload make the view track the camera
let cenAll=[0,0,0];
if(DATA.kf_T.length){for(const T of DATA.kf_T){cenAll[0]+=T[0][3];
 cenAll[1]+=T[1][3];cenAll[2]+=T[2][3];}
 cenAll=cenAll.map(v=>v/DATA.kf_T.length);}
let cen=cenAll;
let yaw=0.6, pitch=0.35, dist=8, panX=0, panY=0;
// view + toggle state survives the auto-refresh reload
try{const st=JSON.parse(localStorage.getItem('plslam_view')||'null');
 if(st){yaw=st.yaw;pitch=st.pitch;dist=st.dist;panX=st.panX;panY=st.panY;
  for(const id of ['tp','tl','tk','tc','tg','tf','ta'])
   if(st[id]!==undefined)document.getElementById(id).checked=st[id];}
}catch(e){}
function saveView(){const st={yaw:yaw,pitch:pitch,dist:dist,panX:panX,
  panY:panY};
 for(const id of ['tp','tl','tk','tc','tg','tf','ta'])
  st[id]=document.getElementById(id).checked;
 try{localStorage.setItem('plslam_view',JSON.stringify(st));}catch(e){}}
function updateCen(){
 if(document.getElementById('tf').checked&&DATA.kf_T.length){
  const T=DATA.kf_T[DATA.kf_T.length-1];
  cen=[T[0][3],T[1][3],T[2][3]];
 } else cen=cenAll;
}
let refreshTimer=null;
function updateRefresh(){
 const on=document.getElementById('ta').checked;
 if(on&&!refreshTimer)refreshTimer=setTimeout(()=>{saveView();
  location.reload();},3000);
 if(!on&&refreshTimer){clearTimeout(refreshTimer);refreshTimer=null;}
}

function mat(){
 const w=cv.width, h=cv.height, f=1.6, n=0.01, fa=1000;
 const a=w/h;
 const cy=Math.cos(yaw), sy=Math.sin(yaw),
       cp=Math.cos(pitch), sp=Math.sin(pitch);
 // camera position on orbit sphere around cen
 const eye=[cen[0]+dist*cy*cp, cen[1]+dist*sp, cen[2]+dist*sy*cp];
 // look-at basis
 let zx=eye[0]-cen[0], zy=eye[1]-cen[1], zz=eye[2]-cen[2];
 const zl=Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
 // x = up x z with up=(0,-1,0) (vision convention: y points down)
 let xx=-zz, xy=0, xz=zx;
 const xl=Math.hypot(xx,xy,xz); xx/=xl; xy/=xl; xz/=xl;
 const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
 const ex=-(xx*eye[0]+xy*eye[1]+xz*eye[2])+panX,
       ey=-(yx*eye[0]+yy*eye[1]+yz*eye[2])+panY,
       ez=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, ex,ey,ez,1];
 // P*V
 const M=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
 return M;
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 cv.width=innerWidth*dpr; cv.height=innerHeight*dpr;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.07,0.07,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT);
 gl.uniformMatrix4fv(uM,false,mat());
 function d(bb,mode,ps){if(!bb.n)return;
  gl.bindBuffer(gl.ARRAY_BUFFER,bb.b);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,24,0);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.FLOAT,false,24,12);
  gl.uniform1f(uS,ps||1.0); gl.drawArrays(mode,0,bb.n);}
 if(document.getElementById('tp').checked) d(bPts,gl.POINTS,2.2);
 if(document.getElementById('tl').checked) d(bLns,gl.LINES);
 if(document.getElementById('tk').checked){d(bFr,gl.LINES);
  d(bTr,gl.LINES);}
 if(document.getElementById('tc').checked) d(bCv,gl.LINES);
 if(DATA.gt&&document.getElementById('tg').checked) d(bGt,gl.LINES);
}
let drag=false,px=0,py=0,shift=false;
cv.addEventListener('mousedown',e=>{drag=true;px=e.clientX;py=e.clientY;
 shift=e.shiftKey;});
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
 if(shift){panX+=dx*0.002*dist; panY+=dy*0.002*dist;}
 else{yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
 draw();});
cv.addEventListener('wheel',e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012); draw();},{passive:false});
for(const id of ['tp','tl','tk','tc','tg','tf','ta'])
 document.getElementById(id).addEventListener('change',()=>{updateCen();
  updateRefresh();saveView();draw();});
addEventListener('mouseup',saveView);
addEventListener('resize',draw);
updateCen();updateRefresh();draw();
</script></body></html>
"""


def export_scene_html(mapper, path: str, gt=None,
                      max_points: int = 20000) -> str:
    """Write a standalone interactive scene viewer for the current map.

    mapper: backend Mapper (or anything with .map/.cfg); gt: optional
    (N, 3+) ground-truth positions.  Returns the path written.
    """
    data = _scene_data(mapper, gt=gt, max_points=max_points)
    html = _HTML.replace("/*DATA*/", json.dumps(data, separators=(",", ":")))
    with open(path, "w") as f:
        f.write(html)
    return path
